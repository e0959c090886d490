"""The reference against itself at a tiny size, and its control."""

import pytest
import torch

from benchmark import cells, drive, reference
from benchmark.ref.accel import blocks
from benchmark.ref.accel import bvh as B


@pytest.fixture(scope="module")
def sponza():
    return reference.Scene(drive.scene_file({"scene": "sponza"}), "cpu")


def _rays(n, seed):
    g = torch.Generator().manual_seed(seed)
    o = (torch.rand(n, 3, generator=g) - 0.5) * torch.tensor([20.0, 6.0, 8.0])
    o = o + torch.tensor([0.0, 3.0, 0.0])
    d = torch.nn.functional.normalize(torch.randn(n, 3, generator=g), dim=1)
    cap = torch.rand(n, generator=g) * 10.0
    act = torch.rand(n, generator=g) > 0.3
    return o, d, cap, act


def _soa(x):
    return tuple(x[:, i].contiguous() for i in range(3))


@pytest.mark.parametrize("tree", ["bvh", "bvh_alpha"])
def test_block_walks_equal_the_plain_walkers(sponza, tree):
    bvh = getattr(sponza.scene, tree)
    assert B.has_payload(bvh)
    o, d, cap, act = _rays(1500, 3)
    for t_max in (None, cap):
        want = B.closest_hit_masked(bvh, o, d, t_max)
        got = blocks.closest(bvh, _soa(o), _soa(d), t_max, masked=True)
        for k in want:
            assert torch.equal(want[k], got[k]), k
        want = B.closest_hit(bvh, o, d, t_max)
        got = blocks.closest(bvh, _soa(o), _soa(d), t_max)
        for k in want:
            assert torch.equal(want[k], got[k]), k
    want = B.any_hit_masked(bvh, o, d, cap, active=act)
    got = blocks.any_hit(bvh, _soa(o), _soa(d), cap, 1e-3, act, masked=True)
    assert torch.equal(want[0], got[0]) and torch.equal(want[1], got[1])
    assert torch.equal(B.any_hit(bvh, o, d, cap, active=act),
                       blocks.any_hit(bvh, _soa(o), _soa(d), cap, 1e-3, act))


def _row():
    return reference.Scene(drive.scene_file({"scene": "matrow"}), "cpu")


def _replay(draws, lanes, stages):
    stages = [dict(begin=b, end=e, state=s) for b, e, s in stages]
    reference.replay_offline(_row(), 64, 32, 9, draws, lanes, stages)
    return [st["result"] for st in stages]


def test_replay_repeats_stages_agree_and_the_control_fails():
    lanes = reference.sample_lanes(64, 32, 9, 200)
    draws = [(1, 6), (2, 8)]
    (a, c), = _replay(draws, lanes, [(0, 14, None)])
    (a2, c2), = _replay(draws, lanes, [(0, 14, None)])
    assert torch.equal(a, a2) and torch.equal(c, c2)
    assert float(c.max()) == 14.0
    assert reference.lanes_apart(a2, c2, a, c) == (0.0, 0)
    # a stage that starts from a state the replay reached itself ends where
    # the whole replay does
    from benchmark.ref.render import integrator as integ

    stages = [dict(begin=0, end=6, state=None)]
    ref = _row()
    lz = reference.Lanes(lanes, 64, 32, "cpu")
    reference.replay_offline(ref, 64, 32, 9, draws, lanes, stages)
    st = stages[0]["cur"]
    assert isinstance(st, integ.PathState)
    (a3, c3), = _replay(draws, lanes, [(6, 14, st)])
    assert reference.lanes_apart(a3, c3, a, c) == (0.0, 0)
    assert len(lz.index) == 200
    lim = drive.limits(cells.Cell("sponza_1080.offline"))
    with reference.bf16():
        (ca, cc), = _replay(draws, lanes, [(0, 14, None)])
    apart, off = reference.lanes_apart(ca, cc, a, c)
    assert apart > 3 * lim["lanes_apart_pct"] and off == 0


def test_lanes_apart_counts_count_and_accum():
    ref_a = torch.ones(3, 4)
    ref_c = torch.full((4,), 6.0)
    a = ref_a.clone()
    a[0, 1] += 1e-3
    c = ref_c.clone()
    c[3] = 5.0
    assert reference.lanes_apart(a, c, ref_a, ref_c) == (50.0, 1)
    a[0, 1] = ref_a[0, 1] + 1e-5
    assert reference.lanes_apart(a, ref_c, ref_a, ref_c) == (0.0, 0)
