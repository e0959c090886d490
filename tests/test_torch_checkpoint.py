"""Checkpoints, resume and --profile of glaze_tpu_torch, on the CPU.

A checkpoint is the JAX package's ``.npz`` key for key, so it crosses
between the packages both ways; a resumed render continues the seed
stream, the scheduler and the path states where they stopped, so it
equals a straight render. Each render here saves after an even number
of launches, as the CLI's path-tracing chunks do: the layout keeps the
PCG64 state but not NumPy's buffered half of a 64-bit draw, so after an
odd number of uint32 seeds a resumed render takes the seeds one later
than a straight one, in both packages (ROADMAP F12). The scenes are
glaze_tpu's tiny scene (a floor, a wall, an OMNI and an AREA light) at
64x32, the same tables in both packages, and the golden scene through
the CLI.
"""

import logging
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch_parity import port_scene_from_jax  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, SEED = 64, 32, 41


@pytest.fixture(scope="module")
def tiny():
    sys.path.insert(0, ROOT)
    import __graft_entry__ as graft

    js, cam = graft._tiny_scene(W, H)
    return js, port_scene_from_jax(js, "cpu"), cam


def _renderer(pkg, tiny, **kw):
    js, ts, cam = tiny
    if pkg == "jax":
        from glaze_tpu.render.renderer import RayTraceRenderer

        return RayTraceRenderer(js, cam, width=W, height=H, seed=SEED, **kw)
    from glaze_tpu_torch.render.renderer import RayTraceRenderer

    return RayTraceRenderer(ts, cam, width=W, height=H, seed=SEED, **kw)


def _leaves(r):
    """The 15 PathState leaves of either package as NumPy."""
    st = r._state
    out = []
    for leaf in (st.importance, *st.origin, *st.direction, st.bounce,
                 st.last_specular, *st.accum, st.count, st.path_no, st.sq):
        out.append(leaf.numpy() if isinstance(leaf, torch.Tensor)
                   else np.asarray(leaf))
    return out


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("sif", [1, 2])
def test_checkpoint_crosses_packages(writer, sif, tiny, tmp_path):
    """``sif`` samples (6 launches) in the writer, a checkpoint, as many
    more in the other package: the same key set both ways, path_no uint32
    on disk, and count and path_no exact against a render of the writer's
    package that went on without a checkpoint (the image within the MC
    bound)."""
    reader = "port" if writer == "jax" else "jax"
    a = _renderer(writer, tiny, samples_in_flight=sif, coherent=1)
    a.draw(sif, return_image=False)
    path_a = str(tmp_path / "a.npz")
    a.save_checkpoint(path_a, scene_id="tiny")
    b = _renderer(reader, tiny, coherent=1)
    b.load_checkpoint(path_a, scene_id="tiny")
    assert b.samples_in_flight == sif and b.completed_spp == sif
    path_b = str(tmp_path / "b.npz")
    b.save_checkpoint(path_b, scene_id="tiny")
    da, db = np.load(path_a), np.load(path_b)
    assert sorted(da.files) == sorted(db.files)
    for k in da.files:
        assert da[k].dtype == db[k].dtype, k
        assert np.array_equal(da[k], db[k]), k
    assert da["leaf_13"].dtype == np.uint32 and int(da["n_leaves"]) == 15
    b.draw(sif, return_image=False)
    straight = _renderer(writer, tiny, samples_in_flight=sif, coherent=1)
    straight.draw(sif, return_image=False)
    straight.draw(sif, return_image=False)
    got, want = _leaves(b), _leaves(straight)
    np.testing.assert_array_equal(got[12], want[12])  # count
    np.testing.assert_array_equal(got[13].astype(np.int64),
                                  want[13].astype(np.int64))  # path_no
    mad = np.abs(b.get_image() / 255.0 - straight.get_image() / 255.0).mean()
    assert mad < 0.06


@pytest.mark.parametrize("kw", [dict(coherent=1),
                                dict(samples_in_flight=2, coherent=2),
                                dict(samples_in_flight=2, sampler="ld",
                                     coherent=0, adaptive=True)],
                         ids=["pcg", "sif2_tile", "sif2_ld_adaptive"])
def test_resume_equals_straight_render(kw, tiny, tmp_path, monkeypatch):
    """A port render resumed from its own checkpoint, in a fresh
    renderer, equals a render that went on without one bit for bit (the
    same draws: adaptive stopping takes its mask once per chunk)."""
    monkeypatch.setenv("GLAZE_ADAPTIVE_MIN", "4")
    monkeypatch.setenv("GLAZE_ADAPTIVE_TAU", "0.5")
    a = _renderer("port", tiny, **kw)
    a.draw(2, return_image=False)
    path = str(tmp_path / "c.npz")
    a.save_checkpoint(path)
    b = _renderer("port", tiny, **kw)
    b.load_checkpoint(path)
    b.draw(2, return_image=False)
    straight = _renderer("port", tiny, **kw)
    straight.draw(2, return_image=False)
    straight.draw(2, return_image=False)
    for i, (g, w) in enumerate(zip(_leaves(b), _leaves(straight))):
        assert g.dtype == w.dtype and np.array_equal(g, w), f"leaf {i}"


def test_scene_id_refused(tiny, tmp_path):
    a = _renderer("port", tiny)
    a.draw(1, return_image=False)
    path = str(tmp_path / "c.npz")
    a.save_checkpoint(path, scene_id="scene-a")
    b = _renderer("port", tiny)
    with pytest.raises(ValueError, match="different scene"):
        b.load_checkpoint(path, scene_id="scene-b")
    b.load_checkpoint(path, scene_id="")  # no identity on one side: loads
    assert b.completed_spp == 1


def test_short_checkpoint_shim_disables_adaptive(tiny, tmp_path):
    """A checkpoint of 13 leaves (before path_no and sq) resumes with
    zeros for them and turns adaptive stopping off with a warning, as in
    glaze_tpu."""
    a = _renderer("port", tiny)
    a.draw(1, return_image=False)
    path = str(tmp_path / "c.npz")
    a.save_checkpoint(path)
    data = dict(np.load(path))
    short = {k: v for k, v in data.items() if k not in ("leaf_13", "leaf_14")}
    short["n_leaves"] = np.asarray(13)
    old = str(tmp_path / "old.npz")
    np.savez(old, **short)
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logger = logging.getLogger("glaze_tpu_torch.renderer")
    logger.addHandler(handler)
    try:
        b = _renderer("port", tiny, adaptive=True)
        b.load_checkpoint(old)
    finally:
        logger.removeHandler(handler)
    assert b.adaptive is False
    assert any("disabling adaptive" in r.getMessage() for r in records)
    assert int(b._state.path_no.abs().sum()) == 0
    assert float(b._state.sq.abs().sum()) == 0.0
    np.testing.assert_array_equal(b._state.count.numpy(),
                                  a._state.count.numpy())
    c = _renderer("port", tiny, adaptive=False)
    c.load_checkpoint(path)  # a full checkpoint leaves adaptive alone
    assert c.adaptive is False
    d = _renderer("port", tiny, adaptive=True)
    d.load_checkpoint(path)
    assert d.adaptive is True


# ---------------------------------------------------------------------------
# the CLI


@pytest.fixture(scope="module")
def scene_file(tmp_path_factory):
    import glaze_tpu_torch.scenes as ps

    path = tmp_path_factory.mktemp("scene") / "row.glaze"
    ps.write_glaze(ps.MatRowScene(), str(path))
    return str(path)


def _cli(scene, out, *flags):
    from glaze_tpu_torch import cli

    return cli.run([scene, str(out), "--res", "48x24", "--seed", "8",
                    "--device", "cpu", *flags])


def test_cli_resume(scene_file, tmp_path, capsys):
    """--spp 1 with a checkpoint, then --spp 2 resumes from it and renders
    one sample more: the state equals a straight two-sample render. A
    checkpoint of another resolution and integrator overrides the flags
    with a note; a checkpoint of another scene exits 2."""
    ck = str(tmp_path / "c.npz")
    code, _, t1 = _cli(scene_file, tmp_path / "a.png", "--spp", "1",
                       "--checkpoint", ck)
    assert code == 0 and os.path.exists(ck) and t1["launches"] == 6
    code, resumed, t2 = _cli(scene_file, tmp_path / "b.png", "--spp", "2",
                             "--checkpoint", ck)
    err = capsys.readouterr().err
    assert code == 0 and f"Resumed {ck}: 1 spp done" in err
    assert t2["launches"] == 6 and resumed.completed_spp == 2
    assert not os.path.exists(ck + ".tmp.npz")
    _, straight, _ = _cli(scene_file, tmp_path / "c.png", "--spp", "2")
    for i, (g, w) in enumerate(zip(_leaves(resumed), _leaves(straight))):
        assert np.array_equal(g, w), f"leaf {i}"
    code, r, _ = _cli(scene_file, tmp_path / "d.png", "--spp", "2",
                      "--checkpoint", ck, "--res", "32x16", "-i", "direct")
    err = capsys.readouterr().err
    assert code == 0 and "Resume overrides flags: 48x24 Path tracing" in err
    assert (r.width, r.height) == (48, 24)
    other = tmp_path / "other.glaze"
    other.write_bytes(open(scene_file, "rb").read() + b"\0")
    code, _, _ = _cli(str(other), tmp_path / "e.png", "--spp", "3",
                      "--checkpoint", ck)
    assert code == 2 and "different scene" in capsys.readouterr().err


def test_cli_ctrl_c_saves_and_exits_130(scene_file, tmp_path, monkeypatch,
                                        capsys):
    """Ctrl-C (a draw that raises KeyboardInterrupt) after the first chunk:
    the CLI saves the checkpoint of the finished chunk and returns 130;
    without --checkpoint the interrupt propagates."""
    from glaze_tpu_torch.render.renderer import RayTraceRenderer

    real = RayTraceRenderer.draw
    calls = []
    interrupt_at = [2]

    def draw(self, spp, *a, **k):
        calls.append(spp)
        if len(calls) == interrupt_at[0]:
            raise KeyboardInterrupt
        return real(self, spp, *a, **k)

    monkeypatch.setattr(RayTraceRenderer, "draw", draw)
    ck = str(tmp_path / "c.npz")
    code, r, _ = _cli(scene_file, tmp_path / "a.png", "--spp", "3",
                      "--checkpoint", ck, "--checkpoint-every", "1")
    assert code == 130 and calls == [1, 1]
    assert "Interrupted: checkpoint saved" in capsys.readouterr().err
    data = np.load(ck)
    assert float(data["leaf_12"].max()) == 6.0  # one sample of 6 launches
    assert not os.path.exists(tmp_path / "a.png")
    calls.clear()
    interrupt_at[0] = 1
    with pytest.raises(KeyboardInterrupt):
        _cli(scene_file, tmp_path / "b.png", "--spp", "3", "--sif", "1",
             "--checkpoint-every", "1")


def test_cli_chunks_align_to_sif(scene_file, tmp_path):
    """--sif 2 --checkpoint-every 1: chunks of whole sif groups, so the
    launches sum to ceil(spp * 6 / 2) and the count is the straight
    render's."""
    ck = str(tmp_path / "c.npz")
    code, r, t = _cli(scene_file, tmp_path / "a.png", "--spp", "3", "--sif",
                      "2", "--checkpoint", ck, "--checkpoint-every", "1")
    assert code == 0 and t["launches"] == 9 and r.completed_spp == 3
    assert float(r._state.count.max()) == 9.0


def test_cli_profile_writes_trace(scene_file, tmp_path, capsys):
    from glaze_tpu_torch.utils.runtime import TRACE_FILE

    prof = tmp_path / "prof"
    code, _, _ = _cli(scene_file, tmp_path / "a.png", "--spp", "1",
                      "--res", "16x8", "--integrator", "direct",
                      "--profile", str(prof))
    err = capsys.readouterr().err
    assert code == 0
    assert (prof / TRACE_FILE).stat().st_size > 0
    assert "Phases: parse=" in err and "render=" in err and "save=" in err
    assert f"Profile trace written to {prof}/" in err
