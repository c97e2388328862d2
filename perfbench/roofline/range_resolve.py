"""Work of the range resolve role (K1, ``resolve_range_kernel``): one
launch a batch of range ops, every replica walking the same ops from the
same visible length.  Bytes: ``workcount.resolve_bytes``; operations: R
times one row's ``workcount.resolve_ops`` (the token walk's tails moved
or clamped and its searches).  On the H100 at R = 1024 the operations
bind."""

from perfbench import workcount as wc


def work(trace, config) -> list[tuple[int, int]]:
    """(bytes, int32 operations) of each launch of one replay, in order."""
    R, B = config["replicas"], config["batch"]
    kind, pos, rlen = wc.range_batches(trace.patches, B)
    v0 = len(trace.start)
    out = []
    for b in range(kind.shape[0]):
        op_t, tail, before, v0_next = wc.token_walk(kind[b], pos[b],
                                                    rlen[b], v0)
        out.append((wc.resolve_bytes(R, B),
                    R * wc.resolve_ops(op_t, tail, before)))
        v0 = v0_next
    return out
