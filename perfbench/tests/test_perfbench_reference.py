"""The plain reference and the seeded inputs."""

from __future__ import annotations

import pytest

from perfbench import inputs
from perfbench.reference.replay import replay, replay_out_of_order


@pytest.mark.parametrize("seed", [0, 2**31 + 17, 987654321987])
def test_reference_replays_sveltecomponent_to_its_end(seed):
    tr = inputs.load("sveltecomponent", seed)
    assert tr.n_patches == 19_749
    assert replay(tr.start, tr.patches) == tr.end


def test_seed_relabels_text_and_keeps_the_work():
    a, b = inputs.load("sveltecomponent", 1), inputs.load("sveltecomponent", 2)
    assert a.end != b.end and len(a.end) == len(b.end)
    shape = lambda t: [(p, d, len(s)) for p, d, s in t.patches]
    assert shape(a) == shape(b)
    assert inputs.load("sveltecomponent", 1) == a  # same seed, same inputs


def test_control_breaks_the_order():
    tr = inputs.load("sveltecomponent", 3)
    assert replay_out_of_order(tr.start, tr.patches, 1536) != tr.end
