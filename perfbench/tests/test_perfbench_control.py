"""``correct`` comes out false for the control and for each fault the
cells can have, planted in the program's timed path: a step that
returns its state unchanged, half of a batch left out, an answer
(replica 0's visible length) altered where it is produced.  (No cell
spans chips, so no exchange can be left out.)  The harness's look for a
card is skipped; the rest of a run is driven on the CPU at the tiny
cells' size."""

from __future__ import annotations

import pytest
import torch

from perfbench import run
from perfbench.spec import find_cell


def one_run(root, cell, control=False):
    return run.run_cell(find_cell(cell, root), 424242, 0.2, False,
                        device="cpu", control=control)


@pytest.mark.parametrize("cell", ["tiny.upstream", "tiny.downstream"])
def test_sound_run_is_correct(tiny_root, cell):
    res = one_run(tiny_root, cell)
    assert res["correct"] and res["checks"]["len_bad"]["value"] == 0


@pytest.mark.parametrize("cell", ["tiny.upstream", "tiny.downstream"])
def test_control_is_not_correct(tiny_root, cell):
    res = one_run(tiny_root, cell, control=True)
    assert not res["correct"]
    assert res["checks"]["text_bad"]["value"] > 0


def every_third(real, broken):
    """A wrapper that calls ``broken`` instead of ``real`` on every third
    call."""
    calls = [0]

    def wrapped(*args):
        calls[0] += 1
        return broken(*args) if calls[0] % 3 == 0 else real(*args)

    return wrapped


def one_hot(nvis):
    """1 for replica 0, 0 for the others: replica 0's visible length,
    an answer of every step, comes out one too long."""
    bump = torch.zeros_like(nvis)
    bump[0] = 1
    return bump


def upstream_faults(monkeypatch, fault):
    from crdt_benches_tpu_torch.engine import replay_range as rr

    apply, resolve = rr.apply_range_batch4, rr.resolve_range
    if fault == "unchanged":
        monkeypatch.setattr(rr, "apply_range_batch4",
                            every_third(apply, lambda st, *_: st))
    elif fault == "half_batch":
        def half(kind, *rest):
            kind = kind.clone()
            kind[kind.shape[0] // 2:] = 0  # PAD: the op is left out
            return resolve(kind, *rest)
        monkeypatch.setattr(rr, "resolve_range", every_third(resolve, half))
    else:
        def altered(*args):
            st = apply(*args)
            return st._replace(nvis=st.nvis + one_hot(st.nvis))
        monkeypatch.setattr(rr, "apply_range_batch4", altered)


def downstream_faults(monkeypatch, fault):
    from crdt_benches_tpu_torch.engine import downstream as dn

    step = dn._apply_update_batch5
    if fault == "unchanged":
        def unchanged(doc, length, nvis, *rest):
            return (doc, length, nvis, step(doc, length, nvis, *rest)[3])
        monkeypatch.setattr(dn, "_apply_update_batch5",
                            every_third(step, unchanged))
    elif fault == "half_batch":
        def half(doc, length, nvis, snap, levels, *wire):
            B = wire[0].shape[0]
            wire = [torch.cat([w[:B // 2], torch.full_like(w[B // 2:], -1)])
                    for w in wire]  # -1: no insert, no delete
            return step(doc, length, nvis, snap, levels, *wire)
        monkeypatch.setattr(dn, "_apply_update_batch5",
                            every_third(step, half))
    else:
        def altered(*args):
            doc, length, nvis, level = step(*args)
            return doc, length, nvis + one_hot(nvis), level
        monkeypatch.setattr(dn, "_apply_update_batch5", altered)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("cell", ["tiny.upstream", "tiny.downstream"])
def test_fault_is_not_correct(tiny_root, monkeypatch, cell, fault):
    plant = upstream_faults if cell == "tiny.upstream" else downstream_faults
    plant(monkeypatch, fault)
    res = one_run(tiny_root, cell)
    assert not res["correct"]
    assert res["failed"] >= 1
