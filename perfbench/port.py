"""What the harness hands the program: a trace as the port's ``TestData``."""

from __future__ import annotations


def as_port_input(trace):
    """``trace`` (``perfbench.inputs.Trace``) as the program's input type."""
    from crdt_benches_tpu_torch.traces.loader import TestData, TestPatch, TestTxn

    return TestData(
        start_content=trace.start,
        end_content=trace.end,
        txns=[TestTxn(time, [TestPatch(*p) for p in ps])
              for time, ps in trace.txns],
    )
