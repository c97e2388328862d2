"""G026's twin: torch index sites and their guards."""

import numpy as np
import torch


def unguarded(x, idx):
    return x.gather(1, idx)  # expect: G026


def clamped_unmasked(x, idx):
    return x.gather(1, idx.clamp(min=0))  # expect: G026


def clamped_masked(x, idx, ok):
    y = x.gather(1, idx.clamp(min=0))  # graftlint: mask=demo-clamp
    return torch.where(ok, y, 0)  # graftlint: mask=demo-clamp


def arange_index(x):
    i = torch.arange(4, dtype=torch.int64)
    return x.index_select(0, i)


def sorted_perm(x, keys):
    _, perm = torch.sort(keys, dim=1)
    return x.gather(1, perm)


def where_index(x, idx, ok):
    safe = torch.where(ok, idx, 0)
    return x.gather(1, safe)


def advanced(x, host):
    j = torch.from_numpy(np.asarray(host))
    return x[j]  # expect: G026


def advanced_store(x, host, v):
    j = torch.from_numpy(np.asarray(host))
    x[j] = v  # expect: G026


def scatter(x, idx, src):
    return x.scatter_add_(1, idx, src)  # expect: G026


def declared(x, row):
    # graftlint: inrange=row<16
    return x.index_select(0, row)


def wrapped(x, idx):
    return x.gather(1, idx % 8)


def lookup_plain(x, idx):
    return x.gather(1, idx)
