"""The pluggable-backend interfaces (a copy of the JAX package's
``backends/base.py``): one editing interface over interchangeable document
engines, with per-backend offset units.

- ``Upstream``: ``NAME``, ``EDITS_USE_BYTE_OFFSETS`` (default False),
  ``from_str`` / ``insert`` / ``remove`` / ``__len__``, and a default
  ``replace`` = remove-then-insert.
- ``Downstream``: ``upstream_updates(trace)`` pre-generates one encoded
  update per patch on a separate upstream replica (untimed), and
  ``apply_update`` integrates one update into this replica (timed).
- ``BatchedReplay``: whole op batches on the device (the port's engines).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Sequence

from ..traces.loader import TestData


class Upstream(ABC):
    """Uniform local-editing interface over document engines."""

    NAME: str = "?"
    #: If True the bench feeds byte offsets (``trace.chars_to_bytes()``).
    EDITS_USE_BYTE_OFFSETS: bool = False

    @classmethod
    @abstractmethod
    def from_str(cls, s: str) -> "Upstream":
        ...

    @abstractmethod
    def insert(self, at: int, text: str) -> None:
        ...

    @abstractmethod
    def remove(self, start: int, end: int) -> None:
        ...

    @abstractmethod
    def __len__(self) -> int:
        """Length in codepoints, or bytes when EDITS_USE_BYTE_OFFSETS."""

    def replace(self, start: int, end: int, text: str) -> None:
        """Default: remove-then-insert."""
        if end > start:
            self.remove(start, end)
        if text:
            self.insert(start, text)

    def content(self) -> str | None:
        """Final document content, if the backend stores text (lengths-only
        engines return None)."""
        return None


class Downstream(ABC):
    """Remote-replica interface: pre-generated updates, timed apply."""

    NAME: str = "?"
    EDITS_USE_BYTE_OFFSETS: bool = False

    @classmethod
    @abstractmethod
    def upstream_updates(
        cls, trace: TestData
    ) -> tuple["Downstream", Sequence[Any]]:
        """Replay ``trace`` on a fresh upstream replica, emitting one encoded
        update per patch; return (fresh downstream replica, updates)."""

    @abstractmethod
    def apply_update(self, update: Any) -> None:
        ...

    @abstractmethod
    def __len__(self) -> int:
        ...

    def clone(self) -> "Downstream":
        """Fresh copy for one timed iteration."""
        raise NotImplementedError


class BatchedReplay(ABC):
    """Whole-trace replay interface for batched/on-device backends.

    The timed region covers document init + full replay + the final length
    check, matching the reference's timed closure."""

    NAME: str = "?"

    @abstractmethod
    def prepare(self, trace: TestData) -> None:
        """Untimed: load/tensorize/stage the trace."""

    @abstractmethod
    def replay_once(self) -> int:
        """Timed: init + replay + return final length (blocking)."""

    def final_content(self) -> str | None:
        return None

    @property
    def replicas(self) -> int:
        return 1


_UPSTREAM_REGISTRY: dict[str, type] = {}
_DOWNSTREAM_REGISTRY: dict[str, type] = {}


def register_upstream(cls):
    _UPSTREAM_REGISTRY[cls.NAME] = cls
    return cls


def register_downstream(cls):
    _DOWNSTREAM_REGISTRY[cls.NAME] = cls
    return cls


def upstream_backends() -> dict[str, type]:
    return dict(_UPSTREAM_REGISTRY)


def downstream_backends() -> dict[str, type]:
    return dict(_DOWNSTREAM_REGISTRY)
