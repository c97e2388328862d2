"""G001's twin: module-scope tensors."""

import numpy as np
import torch

BIG = torch.tensor(1 << 30)  # expect: G001
LANES = torch.arange(128, dtype=torch.int32)  # expect: G001
TABLE: torch.Tensor = torch.from_numpy(np.zeros(4, np.int32))  # expect: G001
HOST_BIG = np.int32(1 << 30)
I32 = torch.int32


def fine(n):
    return torch.zeros(n, dtype=I32)


class Holder:
    cap = 16
