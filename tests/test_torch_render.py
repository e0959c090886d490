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
    """ld, adaptive lane masks and sif > 1 are not ported: the integrator
    refuses them instead of ignoring them."""
    import glaze_tpu_torch.scenes as ps
    from glaze_tpu_torch.render import integrator as ti
    from glaze_tpu_torch.scene import flatten_scene

    scene, cam, _ = flatten_scene(ps.MatRowScene(), "cpu")
    state = ti.init_state(32, 16, "cpu")
    c2w, s2c = ti.camera_matrices(cam, 32, 16)
    px, py = ti.pixel_coords(32, 16, "cpu")
    args = (scene, state, 1, (0.5, 0.5), c2w, s2c, px, py, (32, 16))
    with pytest.raises(NotImplementedError, match="ld"):
        ti.launch_step(*args, is_persp=True, sampler="ld")
    with pytest.raises(NotImplementedError, match="adaptive"):
        ti.launch_step(*args, is_persp=True,
                       lane_active=torch.ones(px.shape, dtype=torch.bool))
    with pytest.raises(NotImplementedError, match="in flight"):
        ti.init_state(32, 16, "cpu", sif=2)
    with pytest.raises(NotImplementedError, match="in flight"):
        ti.render_steps(scene, state, np.zeros(1, np.uint32),
                        np.zeros((1, 2), np.float32), c2w, s2c, width=32,
                        height=16, is_persp=True, direct_only=False, steps=1,
                        sif=2)


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
