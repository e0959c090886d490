"""The sampling options of glaze_tpu_torch against glaze_tpu, on the CPU.

- ``ops/sobol.py`` word for word: the same uint32 words in, including
  words >= 2**31 and 0xFFFFFFFF, give the same words (and floats) out;
- ``sif_lanes`` exactly, and ``tile_error`` (within rtol 1e-5: the tile
  means sum in another order) and ``adaptive_lane_mask`` (exactly) on a
  shared state;
- whole renders with samples in flight, the ``ld`` sampler (coherent 0
  and 1) and adaptive stopping, seeds shared: count, path_no and bounce
  exact, the image within the Monte-Carlo bound of tests/test_goldens.py
  (per-pixel MAD < 0.06), and the float leaves within 1e-4 on all but
  0.1% of the lanes per launch. A lane whose float work rounds apart
  from glaze_tpu's in one launch (F4) stays apart for the rest of the
  render, so after L launches at most L x 0.1% of the lanes may be off;
  the pcg renders that the port already had stay within that too
  (0.15-0.41% of the lanes after one sample at 96x48).
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from torch_parity import (  # noqa: E402
    golden_scenes_pair,
    port_scene_from_jax,
)

WORDS = np.concatenate([
    np.asarray([0, 1, 2, 0x7FFFFFFF, 0x80000000, 0x80000001, 0xC7AFE638,
                0xFFFFFFFE, 0xFFFFFFFF], np.uint32),
    np.random.default_rng(10).integers(0, 2**32, 4087, dtype=np.uint64)
    .astype(np.uint32)])
KEYS = np.roll(WORDS, 3) ^ np.uint32(0x9E3779B9)
DOMAINS = np.concatenate([np.asarray([0xFFFFFFFF, 0xFFFFFFFE, 0, 1],
                                     np.uint32), WORDS[4:]])


def _t(a):
    return torch.from_numpy(a.astype(np.int64))


def _same(got, want):
    want = np.asarray(want)
    if want.dtype == np.uint32:
        want = want.astype(np.int64)
    got = got.numpy()
    assert got.dtype == want.dtype
    assert np.array_equal(got, want)


@pytest.mark.parametrize("fn", ["reverse_bits", "_hash",
                                "nested_uniform_scramble", "seed_keys_int",
                                "seed_keys_words", "sobol02", "sobol1"])
def test_sobol_words_match(fn):
    from glaze_tpu.ops import sobol as js
    from glaze_tpu_torch.ops import sobol as ts

    jw, jk, jd = jnp.asarray(WORDS), jnp.asarray(KEYS), jnp.asarray(DOMAINS)
    tw, tk, td = _t(WORDS), _t(KEYS), _t(DOMAINS)
    if fn in ("reverse_bits", "_hash"):
        _same(getattr(ts, fn)(tw), getattr(js, fn)(jw))
    elif fn == "nested_uniform_scramble":
        _same(ts.nested_uniform_scramble(tw, tk),
              js.nested_uniform_scramble(jw, jk))
    elif fn == "seed_keys_int":
        for dom in (0, 1, 9, 0x7FFFFFFF, 0xFFFFFFFF):
            for g, w in zip(ts.seed_keys(tk, dom), js.seed_keys(jk, dom)):
                _same(g, w)
    elif fn == "seed_keys_words":
        for g, w in zip(ts.seed_keys(tk, td), js.seed_keys(jk, jd)):
            _same(g, w)
    elif fn == "sobol02":
        for dom_t, dom_j in ((0, 0), (td, jd)):
            for g, w in zip(ts.sobol02(tw, tk, dom_t),
                            js.sobol02(jw, jk, dom_j)):
                _same(g, w)
                assert float(g.max()) < 1.0
    else:
        _same(ts.sobol1(tw, tk, td), js.sobol1(jw, jk, jd))
        _same(ts.sobol1(tw, tk, 7), js.sobol1(jw, jk, 7))


def test_mul32_stays_below_int64():
    """The split product equals the exact product mod 2**32 where the
    plain int64 product would overflow."""
    from glaze_tpu_torch.ops.sobol import mul32

    for c in (0x6C50B47C, 0xB82F1E52, 0xC7AFE638, 0x8D22F6E6, 0xFFFFFFFF):
        want = (WORDS.astype(object) * c) % (1 << 32)
        assert np.array_equal(mul32(_t(WORDS), c).numpy(),
                              want.astype(np.int64))


@pytest.mark.parametrize("sif", [1, 2, 3])
def test_sif_lanes_match(sif):
    from glaze_tpu.render import integrator as ji
    from glaze_tpu_torch.render import integrator as ti

    want = ji.sif_lanes(96, 48, sif)
    got = ti.sif_lanes(96, 48, sif, "cpu")
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            assert g.dtype == torch.float32
            assert np.array_equal(g.numpy(), np.asarray(w))
    assert ti.init_state(96, 48, "cpu", sif).count.shape == (
        ti.pixel_count(96, 48) * sif,)


def _moment_state(sif, seed=11):
    """A state of both packages with the same running moments: per-lane
    counts of 2..12 launches, accum and sq drawn so that some tiles are
    converged and some are not."""
    from glaze_tpu.render import integrator as ji
    from glaze_tpu_torch.render import integrator as ti

    rng = np.random.default_rng(seed)
    p = ti.pixel_count(96, 48) * sif
    count = rng.integers(2, 13, p).astype(np.float32)
    mean = rng.uniform(0.0, 2.0, (3, p)).astype(np.float32)
    accum = mean * count
    lum = (0.2126 * accum[0] + 0.7152 * accum[1] + 0.0722 * accum[2]) / count
    # tile t of 2048 lanes gets a relative spread of 10**(t % 3 - 2)
    spread = 10.0 ** (np.arange(p) // 2048 % 3 - 2.0)
    sq = (count * (lum * lum * (1 + spread))).astype(np.float32)
    js = ji.init_state(96, 48, sif)._replace(
        accum=tuple(jnp.asarray(a) for a in accum),
        count=jnp.asarray(count), sq=jnp.asarray(sq))
    ts = ti.init_state(96, 48, "cpu", sif)._replace(
        accum=tuple(torch.from_numpy(a.copy()) for a in accum),
        count=torch.from_numpy(count), sq=torch.from_numpy(sq))
    return js, ts


@pytest.mark.parametrize("sif", [1, 2])
def test_tile_error_and_mask_match(sif):
    from glaze_tpu.render import integrator as ji
    from glaze_tpu_torch.render import integrator as ti

    js, ts = _moment_state(sif)
    want = np.asarray(ji.tile_error(js, sif))
    got = ti.tile_error(ts, sif).numpy()
    assert got.shape == want.shape == (3,)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for tau, min_count in ((0.01, 64.0), (0.1, 2.0), (0.2, 2.0),
                           (1.0, 2.0), (0.2, 7.0)):
        wm = np.asarray(ji.adaptive_lane_mask(js, sif=sif, tau=tau,
                                              min_count=min_count))
        gm = ti.adaptive_lane_mask(ts, sif=sif, tau=tau,
                                   min_count=min_count).numpy()
        assert gm.dtype == np.bool_ and np.array_equal(gm, wm)
    # the cases reach both ends: some tiles park, some stay
    mixed = ti.adaptive_lane_mask(ts, sif=sif, tau=0.2, min_count=2.0)
    assert bool(mixed.any()) and not bool(mixed.all())


# ---------------------------------------------------------------------------
# whole renders


@pytest.fixture(scope="module")
def tiny():
    """glaze_tpu's tiny scene (a floor, a wall, an OMNI and an AREA light)
    and the port's copy of its tables."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import __graft_entry__ as graft

    js, cam = graft._tiny_scene(64, 32)
    return js, port_scene_from_jax(js, "cpu"), cam


@pytest.fixture(scope="module")
def golden():
    js, cam = golden_scenes_pair()
    return js, port_scene_from_jax(js, "cpu"), cam


def _float_lanes_off(got, want):
    p = got.count.shape[0]
    bad = np.zeros(p, bool)
    for name in ("importance", "origin", "direction", "accum", "sq"):
        g = getattr(got, name)
        g = torch.stack(g).numpy() if isinstance(g, tuple) else g.numpy()
        x = getattr(want, name)
        x = (np.stack([np.asarray(v) for v in x]) if isinstance(x, tuple)
             else np.asarray(x))
        bad |= ~np.isclose(g, x, rtol=1e-4, atol=1e-4).reshape(-1, p).all(0)
    return bad


def render_pair(pair, w, h, spp, monkeypatch=None, env=None, **kw):
    """The same render in both packages from the same tables, camera and
    seed; returns the two renderers after ``draw(spp)``."""
    from glaze_tpu.render.renderer import RayTraceRenderer as JRenderer
    from glaze_tpu_torch.render.renderer import RayTraceRenderer

    js, ts, cam = pair
    for k, v in (env or {}).items():
        monkeypatch.setenv(k, v)
    jr = JRenderer(js, cam, width=w, height=h, seed=29, **kw)
    tr = RayTraceRenderer(ts, cam, width=w, height=h, seed=29, **kw)
    jr.draw(spp, return_image=False)
    tr.draw(spp, return_image=False)
    return jr, tr


def assert_renders_agree(jr, tr, label):
    """count, path_no and bounce exact; the image within the MC bound;
    the float leaves within 1e-4 on all but 0.1% of the lanes per
    launch."""
    js, st = jr._state, tr._state
    np.testing.assert_array_equal(st.count.numpy(), np.asarray(js.count))
    np.testing.assert_array_equal(st.path_no.numpy(),
                                  np.asarray(js.path_no).astype(np.int64))
    np.testing.assert_array_equal(st.bounce.numpy(), np.asarray(js.bounce))
    launches = int(np.asarray(js.count).max())
    off = _float_lanes_off(st, js)
    sif = tr.samples_in_flight
    ij = jr.get_image().astype(np.float64) / 255.0
    it = tr.get_image().astype(np.float64) / 255.0
    mad = np.abs(ij - it).mean()
    print(f"{label}: {off.sum()} of {off.size} lanes off 1e-4 after "
          f"{launches} launches, image MAD {mad:.3g}")
    assert off.mean() <= 0.001 * max(launches, 1)
    assert mad < 0.06
    assert tr.get_image().shape == jr.get_image().shape
    assert sif == jr.samples_in_flight


@pytest.mark.parametrize("kw", [
    dict(samples_in_flight=2, sampler="ld", coherent=1),
    dict(sampler="ld", coherent=0),
], ids=["sif2_ld_frame", "ld_off"])
def test_render_matches(kw, tiny):
    jr, tr = render_pair(tiny, 64, 32, 2, **kw)
    assert_renders_agree(jr, tr, str(kw))
    if kw.get("sampler") == "ld":
        # the sub-pixel jitter came from the Sobol streams: every
        # regenerated lane advanced its path index
        assert int(tr._state.path_no.min()) >= 1


def test_adaptive_render_matches(tiny, monkeypatch):
    """Adaptive stopping with a small minimum, two samples in flight and
    the tile chains (coherent 2, one chain per tile and copy): tiles park
    once every pixel has 6 launches over its two copies, and parked
    lanes' counts stop, in both packages."""
    jr, tr = render_pair(tiny, 64, 32, 3, monkeypatch,
                         env={"GLAZE_ADAPTIVE_MIN": "6",
                              "GLAZE_ADAPTIVE_TAU": "0.5"},
                         adaptive=True, samples_in_flight=2, coherent=2)
    assert tr.adaptive_tau == jr.adaptive_tau == 0.5
    assert tr.adaptive_min == jr.adaptive_min == 6.0
    # 9 launches; every lane reached the minimum (3 launches a copy)
    # before its tile parked, and parked lanes stopped counting
    count = tr._state.count
    assert float(count.min()) >= 3.0 and float(count.min()) < 9.0
    assert_renders_agree(jr, tr, "adaptive")


def test_golden_scene_all_options_match(golden, monkeypatch):
    """The golden scene at 96x48 with two samples in flight, ld, coherent
    off and adaptive stopping together, as chip_smoke.py renders them
    at 1080p:
    one sample, three launches of 2 x 6,144 lanes, tiles parking from
    the second."""
    jr, tr = render_pair(golden, 96, 48, 1, monkeypatch,
                         env={"GLAZE_ADAPTIVE_MIN": "2",
                              "GLAZE_ADAPTIVE_TAU": "0.5"},
                         samples_in_flight=2, sampler="ld", coherent=0,
                         adaptive=True)
    count = tr._state.count
    assert count.shape == (2 * 128 * 48,)
    # the minimum counts the two copies of a pixel together: tiles park
    # from the second launch, and their lanes stop counting
    assert float(count.min()) == 1.0 and float(count.max()) == 3.0
    assert_renders_agree(jr, tr, "golden sif2 ld off adaptive")
