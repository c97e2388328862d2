"""G005's twin: torch factories without dtype= in a scoped directory."""

import torch

I32 = torch.int32


def make(n, x, dev):
    a = torch.zeros(4)  # expect: G005
    b = torch.arange(8, device=dev)  # expect: G005
    c = torch.full((2,), 0)  # expect: G005
    d = torch.tensor([1, 2])  # expect: G005
    e = torch.ones(n, dtype=I32)
    f = torch.zeros_like(x)
    g = torch.empty((n, n), dtype=torch.int32, device=dev)
    h = torch.arange(n)  # expect: G005
    return a, b, c, d, e, f, g, h
