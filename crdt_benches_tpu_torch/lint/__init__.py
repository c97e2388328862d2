"""graftlint for the PyTorch port: the JAX package's ``lint/``, both
halves.

The static half (stdlib ``ast`` only; imports neither torch nor jax):
``python -m crdt_benches_tpu_torch.lint [paths] [--select ...]
[--format text|json|sarif] [--changed] [--fix] [--boundaries]
[--sync-artifact|--thread-artifact|--fs-artifact|--lifecycle-artifact|
--ranges-artifact JSON]`` runs :mod:`.rules` over the paths and exits 1
on any finding that survives its ``# graftlint: disable=G0xx``.

The runtime half, which the serve stack reports on:

- :mod:`.sanitizer` — fences and the host-sync tripwire of the hot path;
- :mod:`.boundary` — ``@boundary`` dtype/shape/in-place contracts;
- :mod:`.range_sanitizer` — staged index, narrow-lane and PAD checks;
- :mod:`.race_sanitizer` — publish points and cross-thread ownership;
- :mod:`.fs_sanitizer` — durable protocols, op attribution, crash points;
- :mod:`.lifecycle_sanitizer` — state machines and owned resources.

Each runtime module counts its entries in every mode and checks only
when armed by its ``arm()`` (the serve bench's ``sanitize=``, the
runner's ``--serve-sanitize``); no environment variable arms anything.
The five artifact flags cross-check the static declarations against the
blocks an armed drain writes.
"""

from .boundary import (  # noqa: F401
    REGISTRY,
    BoundaryContract,
    BoundaryError,
    boundary,
    boundary_table,
)
from .core import (  # noqa: F401
    Finding,
    format_json,
    format_sarif,
    format_text,
    run_lint,
)
from .fs_sanitizer import (  # noqa: F401
    DurableOrderingError,
    InjectedCrash,
    crash_at,
    durable_protocol,
    fs_protocol,
    watch_root,
)
from .race_sanitizer import (  # noqa: F401
    SharedProxy,
    UndeclaredCrossThreadAccess,
    publish_point,
    published,
    reveal,
    share,
)
from .sanitizer import (  # noqa: F401
    UndeclaredSyncError,
    fence,
    fenced,
    hot_path,
)

#: The words of the serve bench's ``sanitize=`` (the runner's
#: ``--serve-sanitize``), each arming one module.
SANITIZERS = ("syncs", "races", "fs", "lifecycle", "ranges", "boundaries")

__all__ = [
    "REGISTRY",
    "SANITIZERS",
    "BoundaryContract",
    "BoundaryError",
    "Finding",
    "DurableOrderingError",
    "InjectedCrash",
    "SharedProxy",
    "UndeclaredCrossThreadAccess",
    "UndeclaredSyncError",
    "boundary",
    "boundary_table",
    "crash_at",
    "durable_protocol",
    "fence",
    "fenced",
    "format_json",
    "format_sarif",
    "format_text",
    "fs_protocol",
    "hot_path",
    "publish_point",
    "published",
    "reveal",
    "run_lint",
    "share",
    "watch_root",
]
