"""Runs of a cell with the timed path broken underneath come out not
correct: a step that returns its state unchanged, half of the lanes left
out, the radiance a launch adds altered where it is produced, one BSDF
family altered alone, and on a mesh the exchange between slots left
out. Tiny sizes on the CPU; the look for a card is skipped."""

import pytest
import torch

from benchmark import cells, drive
from benchmark.conftest import row_cell


def _cell(kind, edit_every=1000):
    if kind == "offline":
        cell = row_cell()
        cell.traffic["spp_per_draw"] = 1
    else:
        cell = cells.Cell("sponza_1080.interactive")
        # a short session whose first still run (two frames after two
        # drags) ends inside the window: the start stage holds it
        cell.traffic.update(warmup=["drag", "still", "edit", "still"],
                            segment_frames=[2], edit_every=edit_every)
    cell.config["width"], cell.config["height"] = 64, 32
    return cell


def _mixed(old, new, fn):
    from glaze_tpu_torch.render import integrator as integ

    out = []
    for o, n in zip(old, new):
        if isinstance(o, tuple):
            out.append(tuple(fn(a, b) for a, b in zip(o, n)))
        else:
            out.append(fn(o, n))
    return integ.PathState(*out)


def _unchanged(old, new):
    return old


def _half(old, new):
    def keep_half(o, n):
        h = n.shape[-1] // 2
        return torch.cat([n[..., :h], o[..., h:]], dim=-1)

    return _mixed(old, new, keep_half)


def _altered(old, new):
    return new._replace(accum=tuple(o + (n - o) * 1.01 for o, n in
                                    zip(old.accum, new.accum)))


FAULTS = {"unchanged": _unchanged, "half_left_out": _half,
          "answer_altered": _altered}


def _break(monkeypatch, fault):
    from glaze_tpu_torch.render import integrator as integ

    orig = integ.render_steps

    def broken(scene, state, *a, **k):
        res = orig(scene, state, *a, **k)
        if isinstance(res, tuple) and not hasattr(res, "_fields"):
            return (FAULTS[fault](state, res[0]),) + tuple(res[1:])
        return FAULTS[fault](state, res)

    monkeypatch.setattr(integ, "render_steps", broken)


def _one_family(monkeypatch):
    """The metal family alone altered where it is produced: its sampled
    and evaluated BSDF values 2% low. Only the lanes whose paths meet a
    metal surface part from the reference."""
    from glaze_tpu_torch.render import bsdf

    fam = bsdf.FAMILY_METAL
    for table in (bsdf._SAMPLE_FNS, bsdf._VALUE_FNS):
        orig = table[fam]

        def low(*a, _orig=orig):
            res = _orig(*a)
            k = 1 if len(res) == 3 else 0
            return res[:k] + (res[k] * 0.98,) + res[k + 1:]

        monkeypatch.setitem(table, fam, low)


@pytest.mark.parametrize("fault", sorted(FAULTS) + ["one_family"])
def test_offline_fault_is_caught(monkeypatch, fault):
    if fault == "one_family":
        _one_family(monkeypatch)
    else:
        _break(monkeypatch, fault)
    _, _, checks = drive.run_cell(_cell("offline"), 21, 0.5, False,
                                  device="cpu")
    assert not drive.correct(checks), checks


def test_offline_sound_run_is_correct():
    _, _, checks = drive.run_cell(_cell("offline"), 21, 0.5, False,
                                  device="cpu")
    assert drive.correct(checks), checks


# (fault, edit_every): the last case edits on every frame, so the check's
# frame is an edit, which drops the display history before its launch
@pytest.mark.parametrize("fault,edit_every", [("unchanged", 1000),
                                              ("answer_altered", 1000),
                                              (None, 1000), (None, 1)])
def test_interactive_fault_is_caught(monkeypatch, fault, edit_every):
    if fault is not None:
        _break(monkeypatch, fault)
    _, _, checks = drive.run_cell(_cell("interactive", edit_every), 22, 1.5,
                                  False, device="cpu")
    assert drive.correct(checks) == (fault is None), checks


def _two_slots(monkeypatch):
    from glaze_tpu_torch.parallel import mesh as pmesh

    orig = pmesh.make_mesh
    monkeypatch.setattr(pmesh, "make_mesh",
                        lambda devices=None: orig(["cpu", "cpu"]))


def _gather_drops_slots(monkeypatch):
    """The exchange between slots left out: the gathered state keeps slot
    0's lanes and none of the others'."""
    from glaze_tpu_torch.parallel import mesh as pmesh

    orig = pmesh.unshard_state

    def broken(states, device=None):
        whole = orig(states, device)
        n0 = states[0].count.shape[-1]
        return whole._replace(
            accum=tuple(torch.cat([a[:n0], torch.zeros_like(a[n0:])])
                        for a in whole.accum),
            count=torch.cat([whole.count[:n0],
                             torch.zeros_like(whole.count[n0:])]))

    monkeypatch.setattr(pmesh, "unshard_state", broken)


@pytest.mark.parametrize("fault", [False, True])
def test_mesh_exchange_left_out_is_caught(monkeypatch, fault):
    cell = _cell("offline")
    cell.config["mesh"] = "auto"
    _two_slots(monkeypatch)
    if fault:
        _gather_drops_slots(monkeypatch)
    _, _, checks = drive.run_cell(cell, 23, 0.5, False, device="cpu")
    assert drive.correct(checks) == (not fault), checks
