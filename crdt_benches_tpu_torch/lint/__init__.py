"""The runtime half of the JAX package's ``lint/``: the sanitizers and the
boundary contracts the serve stack reports on (its static AST rules are
not ported).

- :mod:`.sanitizer` — fences and the host-sync tripwire of the hot path;
- :mod:`.boundary` — ``@boundary`` dtype/shape/in-place contracts;
- :mod:`.range_sanitizer` — staged index, narrow-lane and PAD checks;
- :mod:`.race_sanitizer` — publish points and cross-thread ownership;
- :mod:`.fs_sanitizer` — durable protocols, op attribution, crash points;
- :mod:`.lifecycle_sanitizer` — state machines and owned resources.

Each module counts its entries in every mode and checks only when armed
by its ``arm()`` (the serve bench's ``sanitize=``, the runner's
``--serve-sanitize``); no environment variable arms anything.
"""

from .boundary import (  # noqa: F401
    REGISTRY,
    BoundaryContract,
    BoundaryError,
    boundary,
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
    "DurableOrderingError",
    "InjectedCrash",
    "SharedProxy",
    "UndeclaredCrossThreadAccess",
    "UndeclaredSyncError",
    "boundary",
    "crash_at",
    "durable_protocol",
    "fence",
    "fenced",
    "fs_protocol",
    "hot_path",
    "publish_point",
    "published",
    "reveal",
    "share",
    "watch_root",
]
