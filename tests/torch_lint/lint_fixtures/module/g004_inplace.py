"""G004's twin: a read after a call wrote its argument in place."""

from crdt_benches_tpu_torch.lint.boundary import boundary


@boundary(donates=(0,))
def bump(state, k):
    state.add_(k)
    return state


@boundary(dtypes=("int32",))
def pure(state, k):
    return state + k


def stale_read(st, k):
    out = bump(st, k)
    total = st.sum()  # expect: G004
    return out, total


def rebound(st, k):
    st = bump(st, k)
    return st.sum()


def not_written(st, k):
    out = pure(st, k)
    return out, st.sum()


def suppressed(st, k):
    out = bump(st, k)
    return out, st.sum()  # graftlint: disable=G004
