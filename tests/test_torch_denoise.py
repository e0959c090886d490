"""The display denoiser of glaze_tpu_torch against glaze_tpu's, on the CPU.

The same NumPy inputs (made from a seed) go through
``glaze_tpu.render.denoise`` and ``glaze_tpu_torch.render.denoise``:

* ``lane_to_image``: the permutation exactly.
* ``_local_sigma``, ``_atrous``, ``_display_linear``: within 1e-5 of the
  largest magnitude (XLA:CPU may contract the normal dot product into
  fused multiply-adds; a power of 32 of it multiplies a one-ulp
  difference by 32).
* ``denoised_display``: u8 at most one level apart, and at least 99.9% of
  the pixels equal.
* ``gbuffer_pass`` on the 96x48 golden scene and on a scene with an
  opacity map (one alpha round): depth within ROADMAP F8's bound (1e-5
  relative on 99% of the lanes, 1e-4 on all), normal, albedo and world
  position within 1e-4 except at exact-t ties (a lane whose depth agrees
  but whose first hit is another triangle; at most two).

Then the port alone: the behaviour checks of tests/test_denoise.py (noise
shrinks at low spp, identity when converged, normal and depth edges
survive), the renderer's ``denoise`` switch (``get_image`` against
glaze_tpu's filter on the same state, the accumulation untouched) and the
CLI's ``--denoise`` (a PNG, and a checkpoint equal bit for bit to one saved
without it).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from glaze_tpu.render import denoise as jdn  # noqa: E402
from glaze_tpu.render import integrator as ji  # noqa: E402
from glaze_tpu_torch.render import denoise as tdn  # noqa: E402
from glaze_tpu_torch.render import integrator as ti  # noqa: E402
from torch_parity import golden_scenes_pair, port_scene_from_jax  # noqa: E402

RTOL = 1e-5
W, H = 64, 32  # the synthetic images


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(got, want, rtol=RTOL):
    """``got`` (torch) within ``rtol`` of the largest magnitude of
    ``want`` (JAX)."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def _planes(seed, shape=(H, W)):
    """Random guide and radiance planes: unit normals, depths of a few
    surfaces, noisy luminance and three channels, a sigma plane."""
    rng = np.random.default_rng(seed)
    n = rng.normal(size=(3,) + shape).astype(np.float32)
    n /= np.linalg.norm(n, axis=0, keepdims=True)
    n[:, :, : shape[1] // 2] = n[:, :1, :1]  # a flat half
    z = np.where(rng.uniform(size=shape) < 0.1, 1e8,
                 rng.uniform(1.0, 3.0, shape)).astype(np.float32)
    chans = rng.uniform(0.0, 2.0, (3,) + shape).astype(np.float32)
    lum = (0.2126 * chans[0] + 0.7152 * chans[1]
           + 0.0722 * chans[2]).astype(np.float32)
    sigma = rng.uniform(0.0, 0.5, shape).astype(np.float32)
    return n, z, chans, lum, sigma


def _state(seed, width=W, height=H, sif=1, spp_launches=6):
    """A synthetic accumulation (sif copies) and G-buffer of one copy."""
    p = ti.pixel_count(width, height)
    rng = np.random.default_rng(seed)
    count = rng.integers(1, 3, p * sif).astype(np.float32) * spp_launches
    accum = (rng.uniform(0.0, 1.5, (3, p * sif)) * count).astype(np.float32)
    n = rng.normal(size=(3, p)).astype(np.float32)
    n /= np.linalg.norm(n, axis=0, keepdims=True)
    gb = {"normal": n, "depth": rng.uniform(1.0, 4.0, p).astype(np.float32),
          "albedo": rng.uniform(0.0, 1.0, (3, p)).astype(np.float32)}
    return accum, count, gb


def _gb_t(gb):
    return {"normal": tuple(_t(c) for c in gb["normal"]),
            "depth": _t(gb["depth"]),
            "albedo": tuple(_t(c) for c in gb["albedo"])}


def _gb_j(gb):
    return {"normal": tuple(jnp.asarray(c) for c in gb["normal"]),
            "depth": jnp.asarray(gb["depth"]),
            "albedo": tuple(jnp.asarray(c) for c in gb["albedo"])}


# ---------------------------------------------------------------------------
# the functions against glaze_tpu's


@pytest.mark.parametrize("size", [(64, 32), (100, 37)])
def test_lane_to_image_is_the_reference_permutation(size):
    inv_j, pw_j, ph_j = jdn.lane_to_image(*size)
    inv, pw, ph = tdn.lane_to_image(*size, "cpu")
    assert (pw, ph) == (pw_j, ph_j) and inv.dtype == torch.int64
    assert np.array_equal(inv.numpy(), np.asarray(inv_j))


def test_local_sigma_matches_reference():
    _, _, _, lum, _ = _planes(3)
    got = tdn._local_sigma(_t(lum), 3.0)
    _close(got, jdn._local_sigma(jnp.asarray(lum), jnp.float32(3.0)))


@pytest.mark.parametrize("iterations", [1, 4])
def test_atrous_matches_reference(iterations):
    n, z, chans, lum, sigma = _planes(4)
    got = tdn._atrous([_t(c) for c in chans], _t(lum), *(_t(c) for c in n),
                      _t(z), _t(sigma), iterations=iterations)
    want = jdn._atrous([jnp.asarray(c) for c in chans], jnp.asarray(lum),
                       *(jnp.asarray(c) for c in n), jnp.asarray(z),
                       jnp.asarray(sigma), iterations=iterations)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("sif", [1, 2])
def test_display_linear_matches_reference(sif):
    accum, count, gb = _state(5, sif=sif)
    inv_j, pw, ph = jdn.lane_to_image(W, H)
    inv, _, _ = tdn.lane_to_image(W, H, "cpu")
    kw = dict(pw=pw, ph=ph, iterations=4, sif=sif, sigma_l_scale=3.0,
              launches_per_spp=6)
    got, cnt = tdn._display_linear(tuple(_t(a) for a in accum), _t(count),
                                   _gb_t(gb), inv, **kw)
    want, cnt_j = jdn._display_linear(
        tuple(jnp.asarray(a) for a in accum), jnp.asarray(count), _gb_j(gb),
        inv_j, **kw)
    assert np.array_equal(cnt.numpy(), np.asarray(cnt_j))
    for g, w in zip(got, want):
        _close(g, w)


def _u8_agree(got, want):
    """At most one level apart, at least 99.9% of the pixels equal."""
    got = np.asarray(got).astype(np.int32)
    want = np.asarray(want).astype(np.int32)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    assert diff.max() <= 1
    same = (diff == 0).all(-1).mean()
    assert same >= 0.999, f"{same:.4%} of pixels equal"


@pytest.mark.parametrize("sif", [1, 2])
def test_denoised_display_matches_reference(sif):
    accum, count, gb = _state(6, sif=sif)
    inv_j, pw, ph = jdn.lane_to_image(W, H)
    inv, _, _ = tdn.lane_to_image(W, H, "cpu")
    got = tdn.denoised_display(tuple(_t(a) for a in accum), _t(count),
                               _gb_t(gb), inv, 0.8, pw=pw, ph=ph, sif=sif)
    want = jdn.denoised_display(
        tuple(jnp.asarray(a) for a in accum), jnp.asarray(count), _gb_j(gb),
        inv_j, jnp.float32(0.8), pw=pw, ph=ph, sif=sif)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (ph, pw, 3)
    _u8_agree(got.numpy(), want)


# ---------------------------------------------------------------------------
# the G-buffer pass


def _lace_pair():
    from glaze_tpu.scene.flatten import flatten_scene
    from test_torch_alpha import LaceScene

    js, cam, _ = flatten_scene(LaceScene("jax"))
    return js, cam


@pytest.mark.parametrize("scene", ["golden", "lace"])
def test_gbuffer_pass_matches_reference(scene):
    js, cam = golden_scenes_pair() if scene == "golden" else _lace_pair()
    rounds = 0 if scene == "golden" else 1
    ts = port_scene_from_jax(js)
    w, h = 96, 48
    c2w, s2c = ji.camera_matrices(cam, w, h)
    want = jdn.gbuffer_pass(js, jnp.asarray(c2w), jnp.asarray(s2c), width=w,
                            height=h, is_persp=cam.is_perspective,
                            alpha_rounds=rounds)
    got = tdn.gbuffer_pass(ts, c2w, s2c, width=w, height=h,
                           is_persp=cam.is_perspective, alpha_rounds=rounds)
    zj, zt = np.asarray(want["depth"]), got["depth"].numpy()
    sky = zj == np.float32(1e8)
    assert (~sky).mean() > 0.3 and np.array_equal(sky, zt == np.float32(1e8))
    assert np.isclose(zt, zj, rtol=1e-5, atol=0).mean() >= 0.99
    np.testing.assert_allclose(zt, zj, rtol=1e-4, atol=0)
    off = np.zeros(zj.shape, bool)
    for key, atol in (("normal", 1e-4), ("albedo", 1e-4), ("wpos", 1e-4)):
        for g, wv in zip(got[key], want[key]):
            wv = np.asarray(wv)
            off |= ~np.isclose(g.numpy(), wv, rtol=1e-4, atol=atol)
    # an exact-t tie: the depth agrees, the first hit is another triangle
    assert off.sum() <= 2, f"{off.sum()} lanes off"
    assert np.isclose(zt[off], zj[off], rtol=1e-6, atol=0).all()


# ---------------------------------------------------------------------------
# the port alone: the behaviour of tests/test_denoise.py


def _flat_setup(width=W, height=H, noise=0.25, seed=0):
    """Flat radiance plus per-lane noise over a trivial G-buffer."""
    inv, pw, ph = tdn.lane_to_image(width, height, "cpu")
    n = pw * ph
    rng = np.random.default_rng(seed)
    noise_rgb = rng.normal(0.0, noise, size=(3, n)).astype(np.float32)
    ones, zeros = torch.ones(n), torch.zeros(n)
    gb = {"normal": (zeros, zeros, ones), "depth": ones,
          "albedo": (ones, ones, ones)}
    return inv, pw, ph, n, noise_rgb, gb


def _display(vals, count_val, n, gb, inv, pw, ph):
    count = torch.full((n,), float(np.float32(count_val)))
    accum = tuple(torch.clamp(_t(np.asarray(v, np.float32)), min=0.0)
                  * float(np.float32(count_val)) for v in vals)
    img = tdn.denoised_display(accum, count, gb, inv, 1.0, pw=pw, ph=ph)
    return img.numpy().astype(np.float64)


def _srgb_u8(x):
    from glaze_tpu_torch.ops import texture as tx

    return float(tx.linear_to_srgb(torch.tensor(np.float32(x)))) * 255.0


def test_low_spp_noise_shrinks():
    inv, pw, ph, n, noise_rgb, gb = _flat_setup()
    truth = float(np.round(_srgb_u8(0.5)))
    dn_img = _display(0.5 + noise_rgb, ti.PT_STEPS, n, gb, inv, pw, ph)
    raw = _display(0.5 + noise_rgb, 1e7, n, gb, inv, pw, ph)
    assert ((dn_img - truth) ** 2).mean() < ((raw - truth) ** 2).mean() / 4.0


def test_fades_to_identity_when_converged():
    inv, pw, ph, n, _, gb = _flat_setup(noise=0.0)
    px, py = ti.pixel_coords_np(W, H)
    step = (px > 30).astype(np.float32) * 0.6 + 0.15
    grad = py.astype(np.float32) / 64.0
    vals = np.stack([step, grad, step * grad])
    out = _display(vals, ti.PT_STEPS * 4096.0, n, gb, inv, pw, ph)
    raw = _display(vals, 1e9, n, gb, inv, pw, ph)
    assert np.abs(out - raw).max() <= 2.0


def test_normal_and_depth_edges_survive_full_strength():
    inv, pw, ph = tdn.lane_to_image(W, H, "cpu")
    n = pw * ph
    px, _ = ti.pixel_coords_np(W, H)
    left = px < 32
    gb = {"normal": (_t(np.where(left, 1.0, 0.0).astype(np.float32)),
                     torch.zeros(n),
                     _t(np.where(left, 0.0, 1.0).astype(np.float32))),
          "depth": _t(np.where(left, 1.0, 3.0).astype(np.float32)),
          "albedo": (torch.ones(n),) * 3}
    vals = np.stack([np.where(left, 0.9, 0.1).astype(np.float32)] * 3)
    out = _display(vals, ti.PT_STEPS, n, gb, inv, pw, ph)
    assert np.abs(out[:H, :30] - _srgb_u8(0.9)).max() <= 2.0
    assert np.abs(out[:H, 34:W] - _srgb_u8(0.1)).max() <= 2.0


# ---------------------------------------------------------------------------
# the renderer and the CLI


def test_renderer_denoise_toggle_end_to_end():
    """``denoise`` routes get_image through the filter: on the same state
    and G-buffer, the filtered linear planes equal glaze_tpu's within 1e-5
    and the image is glaze_tpu's within one u8 level, a pixel differing
    only where the reference lies within 1e-3 of a half level (the two
    packages' sRGB powers round apart there); the accumulation is
    untouched, the G-buffer is cached until the camera moves, and the
    filtered image differs from the raw one."""
    from glaze_tpu.ops import texture as jtx

    import glaze_tpu_torch.scenes as ps
    from glaze_tpu_torch.render.renderer import RayTraceRenderer

    w, h = ps.GOLDEN_W, ps.GOLDEN_H
    r = RayTraceRenderer(ps.MatRowScene(), width=w, height=h, seed=11,
                         device="cpu")
    r.draw(1, return_image=False)
    before = [a.clone() for a in r._state.accum]
    r.denoise = True
    shown = r.get_image()
    assert shown.shape == (h, w, 3) and shown.dtype == np.uint8
    for b, a in zip(before, r._state.accum):
        assert torch.equal(b, a)
    gb = r._gbuffer()
    assert r._gbuffer() is gb
    inv_j, pw, ph = jdn.lane_to_image(w, h)
    inv, _, _ = tdn.lane_to_image(w, h, "cpu")
    kw = dict(pw=pw, ph=ph, iterations=4, sif=1, sigma_l_scale=3.0,
              launches_per_spp=r.integrator.steps_per_sample)
    got, _ = tdn._display_linear(r._state.accum, r._state.count, gb, inv, **kw)
    want, _ = jdn._display_linear(
        tuple(jnp.asarray(a.numpy()) for a in r._state.accum),
        jnp.asarray(r._state.count.numpy()),
        {k: tuple(jnp.asarray(c.numpy()) for c in v) if isinstance(v, tuple)
         else jnp.asarray(v.numpy()) for k, v in gb.items()}, inv_j, **kw)
    for g, wv in zip(got, want):
        _close(g, wv)
    exposure = jnp.float32(r._exposure())
    levels = np.stack([np.asarray(jtx.linear_to_srgb(
        jnp.clip(c * exposure, 0.0, 1.0)) * 255.0) for c in want], -1)[:h, :w]
    ref = jdn._to_srgb_u8(want, exposure)[:h, :w]
    diff = np.abs(shown.astype(np.int32) - np.asarray(ref).astype(np.int32))
    assert diff.max() <= 1
    assert (np.abs(levels[diff > 0] % 1.0 - 0.5) < 1e-3).all()
    r.denoise = False
    raw = r.get_image()
    assert raw.shape == shown.shape and (shown != raw).any()
    cam = r.camera
    cam.advance(0.25)
    r.update_camera(cam)
    assert r._gbuffer() is not gb


def test_cli_denoise_keeps_the_checkpoint_raw(tmp_path):
    """``--denoise --device cpu`` writes a PNG that differs from the raw
    render's, and the checkpoint of the same render is the one saved
    without ``--denoise``, bit for bit."""
    from PIL import Image

    import glaze_tpu_torch.scenes as ps
    from glaze_tpu_torch import cli

    scene = tmp_path / "row.glaze"
    ps.write_glaze(ps.MatRowScene(), str(scene))
    saved = {}
    for label, extra in (("raw", []), ("denoised", ["--denoise"])):
        out, ck = tmp_path / f"{label}.png", tmp_path / f"{label}.npz"
        code = cli.main([str(scene), str(out), "--res", "48x24", "--spp", "2",
                         "--seed", "3", "--device", "cpu", "--checkpoint",
                         str(ck)] + extra)
        assert code == 0
        saved[label] = (np.asarray(Image.open(out)), dict(np.load(ck)))
    (img_raw, ck_raw), (img_dn, ck_dn) = saved["raw"], saved["denoised"]
    assert img_dn.shape == (24, 48, 3) and (img_dn != img_raw).any()
    assert sorted(ck_raw) == sorted(ck_dn)
    for k in ck_raw:
        assert ck_raw[k].dtype == ck_dn[k].dtype
        assert np.array_equal(ck_raw[k], ck_dn[k]), k
