"""PyTorch/CUDA port of ``crdt_benches_tpu`` for NVIDIA Hopper (H100).

The JAX package beside this one is the reference: module paths and names
mirror it so each counterpart is easy to find.  This package imports
``torch``, ``numpy`` and the standard library only — never ``jax`` and
nothing of ``crdt_benches_tpu`` (host modules it needs are copied).

Slice 1 covers the headline range replay: ``traces`` (loading and range
tensorization), ``ops`` (resolver kernel K1, fused range applies K2 and
K3 and their plain PyTorch versions), ``engine.replay_range``,
``backends.torch_backend`` and ``models.flagship``.  Slice 2 adds the
unit-op engine (``layout="unit"``): unit tensorization, the unit resolver
K5 (``ops.resolve``), the applies of ``ops.apply2`` with the fused unit
apply K6 (``ops.apply_range_fused``) and the expansions K8/K9
(``ops.expand``), and ``engine.replay.ReplayEngine``.  Slice 3 adds the
downstream update apply (``engine.downstream``, ``models.flagship
.downstream``): the epoch id -> position structure (``ops.idpos``), the
slot-indexed v1 apply (``ops.apply``) and the blocked no-cv apply K7
(``ops.expand``).  Hand-written CUDA kernels live in ``csrc/`` and build
at first use (``_build.py``).
"""
