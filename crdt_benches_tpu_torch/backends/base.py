"""The batched-replay backend interface (a copy of the JAX package's
``backends/base.py`` ``BatchedReplay``)."""

from __future__ import annotations

from abc import ABC, abstractmethod

from ..traces.loader import TestData


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
