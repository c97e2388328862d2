"""G002's twin: host syncs reachable from a hot-path root."""

import numpy as np
import torch

from crdt_benches_tpu_torch.lint.sanitizer import kernel_body


def pull(x):  # graftlint: fence
    return x.cpu().numpy()


@kernel_body
def body_plain(x):
    return x.tolist()


def helper(x):
    return x.item()  # expect: G002


class Pool:
    def __init__(self, device):
        self.device = device
        self.state = None

    def round(self, x, host_np):  # graftlint: hot-path
        a = pull(x)
        b = body_plain(x)
        c = helper(x)
        n = int(self.state.length[0])  # expect: G002
        t = torch.ones(3, dtype=torch.int32)
        m = bool(t.any())  # expect: G002
        h = np.asarray(t)  # expect: G002
        k = np.asarray(host_np)
        up = torch.from_numpy(host_np).to(self.device)  # expect: G002
        ok = torch.from_numpy(host_np).to(self.device, non_blocking=True)
        cast = x.to(torch.int64)
        moved = x.to(self.device)
        staged = torch.from_numpy(host_np)
        x.copy_(staged)  # expect: G002
        x.copy_(ok)
        torch.cuda.synchronize()  # expect: G002
        rows = x.tolist()  # expect: G002
        return a, b, c, n, m, h, k, up, cast, moved, rows
