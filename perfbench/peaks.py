"""The card's peaks for the roofline shares (frozen with the benchmark).

Bytes: the H100 SXM's published 3.35 TB/s of HBM3 (NVIDIA's data sheet).
int32 operations: the card's own rate, SMs x 64 INT32 lanes x the
maximum SM clock that ``nvidia-smi`` reports (``chip_smoke.py``'s
``int32_rate``; the data sheet's float32 rate counts 128 lanes and two
operations per FMA, which is not the int32 rate).  A share is stated
against these peaks, with the card's power limit beside it.
"""

from __future__ import annotations

import subprocess
from dataclasses import dataclass

HBM_BYTES_PER_S = 3.35e12
INT32_LANES_PER_SM = 64


@dataclass(frozen=True)
class Peaks:
    bytes_per_s: float
    int32_per_s: float
    power_limit: str  # as nvidia-smi prints it, e.g. "700.00 W"
    max_sm_clock: str

    def bound_s(self, nbytes: int, nops: int) -> tuple[float, str]:
        """The least time of a launch and which peak sets it."""
        tb, to = nbytes / self.bytes_per_s, nops / self.int32_per_s
        return (tb, "bytes") if tb >= to else (to, "operations")


def smi(field: str) -> str:
    """One ``nvidia-smi --query-gpu`` field of card 0."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={field}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0].strip()


def card_peaks() -> Peaks:
    """The peaks of CUDA card 0."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = smi("clocks.max.sm")
    return Peaks(
        bytes_per_s=HBM_BYTES_PER_S,
        int32_per_s=sms * INT32_LANES_PER_SM * float(clock.split()[0]) * 1e6,
        power_limit=smi("power.limit"),
        max_sm_clock=clock,
    )
