"""G005's autofixer: every call here gets the dtype it already has, but
the non-literal arange, which is refused."""

import torch


def make(n):
    a = torch.arange(8)  # expect: G005
    b = torch.zeros((2, 3))  # expect: G005
    c = torch.full((2,), 1.5)  # expect: G005
    d = torch.tensor([True, False])  # expect: G005
    e = torch.arange(0, 10, 2,  # expect: G005
                     )
    f = torch.arange(n)  # expect: G005
    return a, b, c, d, e, f
