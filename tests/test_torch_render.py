"""Whole renders of the port on the CPU: the golden scene against the JAX
package's stored golden, and the CLI writing a PNG."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens",
                      "matrow_coh1.npz")


def test_golden_render_coherent_frame():
    """96x48, coherent 1, pcg, 8 spp, seed 1234 (tests/goldens/matrow_coh1.npz,
    rendered by glaze_tpu on XLA:CPU): count exact, and the clipped mean
    radiance within the Monte-Carlo bounds tests/test_goldens.py uses for
    the coherent modes (per-pixel MAD < 0.06, image mean within 3%). The
    seeds are the same, so the two renders agree far closer than that."""
    import glaze_tpu_torch.scenes as ps
    from glaze_tpu_torch.render.renderer import RayTraceRenderer

    g = np.load(GOLDEN)
    r = RayTraceRenderer(ps.MatRowScene(), width=ps.GOLDEN_W,
                         height=ps.GOLDEN_H, seed=ps.GOLDEN_SEED, coherent=1,
                         device="cpu")
    img = r.draw(ps.GOLDEN_SPP)
    assert int(g["spp"]) == ps.GOLDEN_SPP
    assert img.shape == (ps.GOLDEN_H, ps.GOLDEN_W, 3) and img.dtype == np.uint8
    accum = torch.stack(r._state.accum, -1).numpy()
    count = r._state.count.numpy()
    np.testing.assert_array_equal(count, g["count"])
    assert np.isfinite(accum).all()
    ca = np.clip(accum / np.maximum(count, 1.0)[:, None], 0.0, 1.0)
    cg = np.clip(g["accum"] / np.maximum(g["count"], 1.0)[:, None], 0.0, 1.0)
    assert abs(ca.mean() - cg.mean()) < 0.03 * max(cg.mean(), 1e-6)
    mad = np.abs(ca - cg).mean()
    assert mad < 0.06, f"per-pixel MAD {mad} exceeds MC noise bound"
    # same seeds, same chains: nearly every lane reproduces the golden
    close = np.isclose(accum, g["accum"], rtol=2e-3, atol=2e-3).all(axis=1)
    print(f"per-pixel MAD {mad:.3g}; lanes off the golden beyond 2e-3: "
          f"{(~close).sum()} of {close.size}")
    assert close.mean() > 0.99


def test_cli_writes_png(tmp_path):
    from PIL import Image

    import glaze_tpu_torch.scenes as ps
    from glaze_tpu_torch import cli

    scene = tmp_path / "row.glaze"
    ps.write_glaze(ps.MatRowScene(), str(scene))
    out = tmp_path / "row.png"
    code = cli.main([str(scene), str(out), "--res", "48x24", "--spp", "1",
                     "--seed", "5", "--device", "cpu"])
    assert code == 0
    img = np.asarray(Image.open(out))
    assert img.shape == (24, 48, 3)
    assert img.mean() > 10


def test_unported_sampling_options_raise():
    """The sampling options that the port refused before this slice now
    run and agree with glaze_tpu: one launch_step each, from the same
    state on the golden scene at 32x16, with the ld sampler (coherent 0,
    the Sobol draws in every decision), and from init_state(sif=2) (two
    copies of the grid, per-copy chains and jitters) with an adaptive lane
    mask (parked lanes neither regenerate nor count). count, path_no and
    bounce exact; float leaves within 1e-4 on 99.9% of the lanes."""
    import jax
    import jax.numpy as jnp

    from glaze_tpu.render import integrator as ji
    from glaze_tpu_torch.render import integrator as ti
    from torch_parity import golden_scenes_pair, port_scene_from_jax

    w, h = 32, 16
    js, cam = golden_scenes_pair()
    ts = port_scene_from_jax(js, "cpu")
    c2w, s2c = ti.camera_matrices(cam, w, h)
    p = ti.pixel_count(w, h)
    active = np.arange(2 * p) % 3 != 0
    cases = (
        ("ld", 1, dict(sampler="ld", coherent=0, sampler_seed=0x8BADF00D)),
        ("sif2_lane_active", 2, dict(coherent=1, lane_active=active)),
    )
    step = jax.jit(ji.launch_step, static_argnames=(
        "is_persp", "coherent", "sampler"))
    for label, sif, kw in cases:
        jpx, jpy, jrpy = ji.sif_lanes(w, h, sif)
        tpx, tpy, trpy = ti.sif_lanes(w, h, sif, "cpu")
        offset = np.asarray([[0.25, 0.75], [0.625, 0.125]][:sif], np.float32)
        if sif == 1:
            j_off, t_off = jnp.asarray(offset[0]), offset[0]
        else:
            j_off = (jnp.repeat(jnp.asarray(offset[:, 0]), p),
                     jnp.repeat(jnp.asarray(offset[:, 1]), p))
            t_off = tuple(torch.from_numpy(np.repeat(offset[:, i], p))
                          for i in range(2))
        jkw = dict(kw)
        tkw = dict(kw)
        if "sampler_seed" in kw:
            jkw["sampler_seed"] = jnp.uint32(kw["sampler_seed"])
        if "lane_active" in kw:
            jkw["lane_active"] = jnp.asarray(active)
            tkw["lane_active"] = torch.from_numpy(active)
        want = step(
            js, ji.init_state(w, h, sif), jnp.uint32(0xC0FFEE), j_off,
            jnp.asarray(c2w), jnp.asarray(s2c), jpx, jpy,
            jnp.asarray([w, h], jnp.float32), is_persp=True, rng_py=jrpy,
            **jkw)
        got = ti.launch_step(
            ts, ti.init_state(w, h, "cpu", sif), 0xC0FFEE, t_off, c2w, s2c,
            tpx, tpy, (w, h), is_persp=True, rng_py=trpy, **tkw)
        assert got.count.shape == (p * sif,)
        np.testing.assert_array_equal(got.count.numpy(), np.asarray(want.count))
        np.testing.assert_array_equal(
            got.path_no.numpy(), np.asarray(want.path_no).astype(np.int64))
        np.testing.assert_array_equal(got.bounce.numpy(),
                                      np.asarray(want.bounce))
        bad = np.zeros(p * sif, bool)
        for name in ("importance", "origin", "direction", "accum", "sq"):
            g, x = getattr(got, name), getattr(want, name)
            g = torch.stack(g).numpy() if isinstance(g, tuple) else g.numpy()
            x = (np.stack([np.asarray(v) for v in x]) if isinstance(x, tuple)
                 else np.asarray(x))
            bad |= ~np.isclose(g, x, rtol=1e-4, atol=1e-4).reshape(
                -1, p * sif).all(0)
        print(f"{label}: {bad.sum()} of {bad.size} lanes outside 1e-4")
        assert bad.mean() <= 0.001
        if "lane_active" in kw:
            # parked lanes: no camera ray, no count
            assert np.array_equal(got.count.numpy() > 0, active)
            assert np.array_equal(got.path_no.numpy() > 0, active)


def test_direct_integrator_and_restart():
    """DIRECT runs one launch per sample; a camera update restarts the
    accumulation."""
    import glaze_tpu_torch.scenes as ps
    from glaze_tpu_torch.render.renderer import Integrator, RayTraceRenderer

    r = RayTraceRenderer(ps.MatRowScene(), width=32, height=16, seed=3,
                         integrator=Integrator.DIRECT, device="cpu")
    r.draw(2, return_image=False)
    assert r.completed_spp == 2
    r.update_camera(r.camera)
    r.draw(1, return_image=False)
    assert r.completed_spp == 1
    r.set_integrator(Integrator.PATH_TRACE)
    img = r.draw(1)
    assert r.completed_spp == 1 and img.mean() > 5
