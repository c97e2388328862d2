"""The frozen work counts of the roofline shares, against values worked by
hand at small shapes, and against the program's own token walk."""

from __future__ import annotations

import numpy as np
import pytest

from perfbench import inputs, workcount as wc
from perfbench.spec import ROOT, load_module

I, D = wc.INSERT, wc.DELETE


def test_token_walk_by_hand():
    # a document of 10 characters is one token [0, 10).  Insert 3 at 0:
    # token 0, nothing split, a new token before it (tail 1: the run).
    # Insert 2 at 1: token 0 [0, 3) splits in three (tail 2, 4 in use).
    # Delete 2 at 0: token 0 [0, 1) clamped with the 3 after it (tail 4,
    # no split).  A PAD changes nothing.
    op_t, tail, before, total = wc.token_walk(
        [I, I, D, wc.PAD], [0, 1, 0, 0], [3, 2, 2, 0], 10)
    assert op_t.tolist() == [0, 0, 0, -1]
    assert before.tolist() == [1, 2, 4, 4]
    assert tail.tolist() == [1, 2, 4, 0]
    assert total == 13
    # 3 fields of each tail token, plus ceil(log2(in use + 1)) compares:
    # (3*1 + 1) + (3*2 + 2) + (3*4 + 3)
    assert wc.resolve_ops(op_t, tail, before) == 4 + 8 + 15


def test_byte_counts_by_hand():
    # T = round_up(2*4 + 2, 128) = 128: 4 op fields, v0, then per row
    # 4 token fields, 3 delete fields and nused, all int32
    assert wc.resolve_bytes(2, 4) == 4 * 4 * 4 + 2 * 4 + 2 * (4 * 128 + 12 + 1) * 4
    # the applies count the live columns: 22 B (K2/K3) or 12 B (K7) a
    # column below the new length, 4 B a live tile, new_len
    assert wc.range_apply_work(2, 100, 1024) == (2 * (22 * 100 + 4 + 4),
                                                 2 * 12 * 100)
    assert wc.range_apply_work(2, 5000, 1024) == (
        2 * (22 * 1024 + 4 * 8 + 4), 2 * 12 * 1024)
    assert wc.down_apply_work(2, 300, 512) == (2 * (12 * 300 + 4 * 3 + 4),
                                               2 * 6 * 300)


def test_staging_by_hand():
    assert [wc.stage_capacity(n, 1024) for n in (1, 8192, 8193, 12289,
                                                   182_315)] == [
        8192, 8192, 12288, 16384, 196_608]
    assert wc.token_list_size(1536) == 3200


def test_batches_by_hand():
    # a typing run coalesces; a backspace run coalesces leftward
    patches = [(0, 0, "ab"), (2, 0, "c"), (2, 1, ""), (1, 1, ""),
               (0, 0, "x")]
    kind, pos, rlen = wc.range_batches(patches, 4)
    assert kind.tolist() == [[I, D, I, wc.PAD]]
    assert pos.tolist() == [[0, 1, 0, 0]]
    assert rlen.tolist() == [[3, 2, 1, 0]]
    assert wc.unit_insert_batches(patches, 4).tolist() == [3, 1]


@pytest.mark.parametrize("name,B,batches", [("sveltecomponent", 64, 24),
                                            ("automerge-paper", 1536, 2)])
def test_walk_equals_the_programs(name, B, batches):
    """The frozen walk counts what ``chip_smoke.py``'s ``k1_ops`` counts
    over the program's ``range_token_walk``, and the frozen range ops are
    the program's coalesced range tensorization."""
    import torch

    from crdt_benches_tpu_torch.ops.resolve_range import range_token_walk
    from crdt_benches_tpu_torch.traces.tensorize import tensorize_ranges
    from perfbench.port import as_port_input

    tr = inputs.load(name, 11)
    kind, pos, rlen = wc.range_batches(tr.patches, B)
    kb, pb, lb, _ = tensorize_ranges(as_port_input(tr), batch=B,
                                     coalesce=True).batched()
    assert (kb == kind).all() and (pb == pos).all() and (lb == rlen).all()
    v0 = len(tr.start)
    for b in range(batches):
        walk = range_token_walk(*(torch.as_tensor(x[b]) for x in (kb, pb, lb)),
                                torch.tensor([v0], dtype=torch.int32))
        steps = torch.ceil(torch.log2(walk.nused[:, :-1].double() + 1)).long()
        theirs = int((3 * walk.tail + torch.where(walk.t >= 0, steps, 0)).sum())
        op_t, tail, before, total = wc.token_walk(kind[b], pos[b], rlen[b], v0)
        assert wc.resolve_ops(op_t, tail, before) == theirs
        assert total == int(walk.total[0])
        v0 = total


def test_roles_count_one_launch_a_batch():
    tr = inputs.load("sveltecomponent", 5)
    cfg = {"replicas": 4, "batch": 1536, "pack": 8}
    n_range = wc.range_batches(tr.patches, 1536)[0].shape[0]
    n_unit = len(wc.unit_insert_batches(tr.patches, 1536))
    for role, n in (("range_resolve", n_range), ("range_apply", n_range),
                    ("down_apply", n_unit)):
        work = load_module(ROOT, "roofline", role).work(tr, cfg)
        assert len(work) == n
        assert all(b > 0 and o > 0 for b, o in work)
    # the applies' live columns grow with the document
    caps = load_module(ROOT, "roofline", "range_apply").capacities(tr, cfg)
    assert np.all(np.diff(caps[0]) >= 0) and caps[0][-1] <= caps[1][-1]
