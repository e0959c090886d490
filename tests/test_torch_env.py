"""The JAX package's environment switches in glaze_tpu_torch, on the CPU.

Each switch gives the same result in both packages:

- ``GLAZE_TILE``: the lane swizzle bit for bit and coherent mode 2's tile
  chains (one launch_step from the same state), and the ValueError of a
  tile that is not one 2048-lane packet;
- ``GLAZE_COHERENT``: the renderer's mode (argument > variable >
  default) and a whole render in the mode the variable picks;
- ``GLAZE_ALPHA_ROUNDS``: the renderer's round count and a whole render
  with it;
- ``GLAZE_ALPHA_MASK=0``: the flattened tables field for field (no cell
  masks baked) and a whole render on the opaque/alpha split;
- ``GLAZE_SIF``, ``GLAZE_SAMPLER``, ``GLAZE_ADAPTIVE`` (with
  ``GLAZE_ADAPTIVE_TAU`` and ``GLAZE_ADAPTIVE_MIN``): both renderers take
  the variable where no argument is given and the argument over it, and
  the CLI renders with it (a fresh interpreter with the variables set).

glaze_tpu reads GLAZE_TILE and GLAZE_ALPHA_ROUNDS once, at import, and so
does the port GLAZE_TILE: a subprocess shows both imports read the same
values. In this process the tests never reload a module; they set the
import-time globals of both packages to what the import reads (a jitted
function of glaze_tpu would keep the tile it traced, so under a changed
tile glaze_tpu runs only eagerly here). Whole renders are of the lace
scene of tests/test_torch_alpha.py at 96x48, one sample (6 launches),
seeds shared: count exact, the clipped image mean within 3% and the
per-pixel MAD below 0.06, the Monte-Carlo bound of tests/test_goldens.py.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from test_torch_alpha import LaceScene  # noqa: E402
from torch_parity import golden_scenes_pair, port_scene_from_jax  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RW, RH, RSEED = 96, 48, 23
VARS = ("GLAZE_TILE", "GLAZE_COHERENT", "GLAZE_ALPHA_ROUNDS",
        "GLAZE_ALPHA_MASK", "GLAZE_SIF", "GLAZE_SAMPLER", "GLAZE_ADAPTIVE",
        "GLAZE_TREE", "GLAZE_FATLEAF")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    """Every test starts with none of the switches set."""
    for var in VARS:
        monkeypatch.delenv(var, raising=False)


# ---------------------------------------------------------------------------
# what the imports read

_IMPORT_PROBE = """
import importlib, json
import numpy as np
out = {}
mods = {}
for pkg in ("glaze_tpu_torch", "glaze_tpu"):
    try:
        mods[pkg] = importlib.import_module(pkg + ".render.integrator")
        out[pkg] = [mods[pkg].TILE_W, mods[pkg].TILE_H]
    except ValueError as e:
        out[pkg] = "ValueError: " + str(e)
if len(mods) == 2:
    a = mods["glaze_tpu"].pixel_coords_np(96, 48)
    b = mods["glaze_tpu_torch"].pixel_coords_np(96, 48)
    out["same_swizzle"] = bool(np.array_equal(a, b))
    from glaze_tpu.render.renderer import RayTraceRenderer
    from glaze_tpu_torch.render.renderer import alpha_rounds
    out["alpha_rounds"] = [alpha_rounds(), RayTraceRenderer._ALPHA_ROUNDS]
print(json.dumps(out))
"""


@pytest.mark.parametrize("tile,rounds", [("64x32", "3"), ("100x20", None)])
def test_import_time_reads_agree(tile, rounds):
    """A fresh interpreter with GLAZE_TILE (and GLAZE_ALPHA_ROUNDS) set:
    both integrators take the tile, swizzle the lanes alike and agree on
    the round count, or both refuse a tile that is not one packet with
    the same ValueError."""
    env = {k: v for k, v in os.environ.items() if k not in VARS}
    env["GLAZE_TILE"] = tile
    if rounds is not None:
        env["GLAZE_ALPHA_ROUNDS"] = rounds
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in (env.get("PYTHONPATH"),) if p])
    env.setdefault("JAX_PLATFORMS", "cpu")
    res = subprocess.run([sys.executable, "-c", _IMPORT_PROBE], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["glaze_tpu_torch"] == out["glaze_tpu"]
    if rounds is None:
        assert out["glaze_tpu"] == ("ValueError: GLAZE_TILE must multiply to "
                                    "2048 (one packet)")
    else:
        assert out["glaze_tpu"] == [64, 32] and out["same_swizzle"]
        assert out["alpha_rounds"] == [3, 3]


def test_tile_from_env(monkeypatch):
    from glaze_tpu_torch.render import integrator as ti

    assert ti.tile_from_env() == (128, 16)
    monkeypatch.setenv("GLAZE_TILE", "")
    assert ti.tile_from_env() == (128, 16)
    monkeypatch.setenv("GLAZE_TILE", "256x8")
    assert ti.tile_from_env() == (256, 8)
    monkeypatch.setenv("GLAZE_TILE", "64x64")
    with pytest.raises(ValueError, match="2048"):
        ti.tile_from_env()


# ---------------------------------------------------------------------------
# GLAZE_TILE: the swizzle and coherent mode 2's chains


@pytest.fixture(scope="module")
def golden():
    js, cam = golden_scenes_pair()
    return js, port_scene_from_jax(js, "cpu"), cam


@pytest.mark.parametrize("tile", [(64, 32), (256, 8)])
def test_tile_swizzle_and_chains_vs_jax(tile, golden, monkeypatch):
    """At a GLAZE_TILE tile (both integrators' globals set as their imports
    would set them): padded dims and the lane swizzle are bit for bit
    glaze_tpu's, and one coherent-2 launch_step from a fresh state on the
    golden scene at 96x48 matches glaze_tpu's (count, path_no and bounce
    exact; floats within 1e-4 on 99.9% of lanes, as
    tests/test_torch_integrator.py holds them). Every draw of the launch
    comes from the tile chains: the frame chain in their place moves more
    than a tenth of the lanes."""
    from glaze_tpu.render import integrator as ji
    from glaze_tpu_torch.render import integrator as ti

    for mod in (ji, ti):
        monkeypatch.setattr(mod, "TILE_W", tile[0])
        monkeypatch.setattr(mod, "TILE_H", tile[1])
    for w, h in ((96, 48), (1920, 1080), (33, 17)):
        assert ti.padded_dims(w, h) == ji.padded_dims(w, h)
        a, b = ji.pixel_coords_np(w, h), ti.pixel_coords_np(w, h)
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    js, ts, cam = golden
    w, h = 96, 48
    c2w, s2c = ji.camera_matrices(cam, w, h)
    seed, offset = 0x2545F491, (0.375, 0.625)
    px, py = ji.pixel_coords(w, h)
    want = ji.launch_step(
        js, ji.init_state(w, h), jnp.uint32(seed),
        jnp.asarray(offset, jnp.float32), jnp.asarray(c2w), jnp.asarray(s2c),
        px, py, jnp.asarray([w, h], jnp.float32), is_persp=True, coherent=2)
    tpx, tpy = ti.pixel_coords(w, h, "cpu")

    def port(coherent):
        return ti.launch_step(ts, ti.init_state(w, h, "cpu"), seed, offset,
                              c2w, s2c, tpx, tpy, (w, h), is_persp=True,
                              coherent=coherent)

    got = port(2)
    assert np.array_equal(got.count.numpy(), np.asarray(want.count))
    assert np.array_equal(got.path_no.numpy(),
                          np.asarray(want.path_no).astype(np.int64))
    assert np.array_equal(got.bounce.numpy(), np.asarray(want.bounce))
    bad = _lanes_off(got, want)
    print(f"tile {tile}: {bad.sum()} of {bad.size} lanes outside 1e-4")
    assert bad.mean() <= 0.001
    # the comparison sees the chains: the frame chain (tile 0's) in every
    # tile moves most of the lanes of the other tiles
    moved = _lanes_off(port(1), want).mean()
    print(f"tile {tile}: the frame chain moves {moved:.3f} of the lanes")
    assert moved > 0.1


def _lanes_off(got, want):
    """Lanes where a float field of a port PathState is off a glaze_tpu
    one by more than 1e-4."""
    p = got.count.shape[0]
    bad = np.zeros(p, bool)
    for name in ("importance", "origin", "direction", "accum"):
        g = getattr(got, name)
        g = torch.stack(g).numpy() if isinstance(g, tuple) else g.numpy()
        x = getattr(want, name)
        x = (np.stack([np.asarray(v) for v in x]) if isinstance(x, tuple)
             else np.asarray(x))
        bad |= ~np.isclose(g, x, rtol=1e-4, atol=1e-4).reshape(-1, p).all(0)
    return bad


# ---------------------------------------------------------------------------
# GLAZE_COHERENT, GLAZE_ALPHA_ROUNDS, GLAZE_ALPHA_MASK: whole renders


def _renderers(**kw):
    from glaze_tpu.render.renderer import RayTraceRenderer as JRenderer
    from glaze_tpu_torch.render.renderer import RayTraceRenderer

    jr = JRenderer(LaceScene("jax"), width=RW, height=RH, seed=RSEED, **kw)
    tr = RayTraceRenderer(LaceScene("torch"), width=RW, height=RH,
                          seed=RSEED, device="cpu", **kw)
    return jr, tr


def _render_agrees(jr, tr, label):
    """One sample of each: count exact, the Monte-Carlo bound."""
    jr.draw(1, return_image=False)
    tr.draw(1, return_image=False)
    cj, ct = np.asarray(jr._state.count), tr._state.count.numpy()
    np.testing.assert_array_equal(ct, cj)
    aj = np.stack([np.asarray(c) for c in jr._state.accum], -1)
    at = torch.stack(tr._state.accum, -1).numpy()
    assert np.isfinite(at).all()
    ca = np.clip(at / np.maximum(ct, 1.0)[:, None], 0.0, 1.0)
    cg = np.clip(aj / np.maximum(cj, 1.0)[:, None], 0.0, 1.0)
    mad = np.abs(ca - cg).mean()
    print(f"{label}: per-pixel MAD {mad:.3g}, image mean {ca.mean():.5f} "
          f"vs {cg.mean():.5f}")
    assert cg.mean() > 1e-3
    assert abs(ca.mean() - cg.mean()) < 0.03 * cg.mean()
    assert mad < 0.06


@pytest.mark.parametrize("value,mode", [
    (None, 1), ("", 1), ("off", 0), ("0", 0), ("frame", 1), ("1", 1),
    ("tile", 2), ("2", 2)])
def test_coherent_env_picks_the_same_mode(value, mode, monkeypatch):
    """RayTraceRenderer's coherent mode: the argument, else GLAZE_COHERENT,
    else frame, in both packages."""
    if value is not None:
        monkeypatch.setenv("GLAZE_COHERENT", value)
    jr, tr = _renderers()
    assert jr.coherent == tr.coherent == mode
    jr, tr = _renderers(coherent="off" if mode else "tile")
    assert jr.coherent == tr.coherent == (0 if mode else 2)


def test_coherent_env_refuses_a_bad_mode(monkeypatch):
    from glaze_tpu.render.renderer import default_coherent as j_default
    from glaze_tpu_torch.render.renderer import default_coherent

    monkeypatch.setenv("GLAZE_COHERENT", "3")
    for fn in (j_default, default_coherent):
        with pytest.raises(ValueError, match="coherent mode must be"):
            fn()
    monkeypatch.setenv("GLAZE_COHERENT", "tiles")
    for fn in (j_default, default_coherent):
        with pytest.raises(ValueError, match="expected off, frame or tile"):
            fn()


def test_coherent_env_render_vs_jax(monkeypatch):
    """GLAZE_COHERENT=tile with no argument: both renderers take mode 2
    (three tile chains at 96x48) and render alike."""
    monkeypatch.setenv("GLAZE_COHERENT", "tile")
    jr, tr = _renderers()
    assert jr.coherent == tr.coherent == 2
    _render_agrees(jr, tr, "GLAZE_COHERENT=tile")


def test_alpha_rounds_env_render_vs_jax(monkeypatch):
    """GLAZE_ALPHA_ROUNDS=2: the port's renderer reads it (0 still without
    an opacity map); glaze_tpu's class attribute holds what its import
    reads (test_import_time_reads_agree); the renders agree."""
    from glaze_tpu.render.renderer import RayTraceRenderer as JRenderer
    from glaze_tpu_torch.render.renderer import RayTraceRenderer

    monkeypatch.setenv("GLAZE_ALPHA_ROUNDS", "2")
    monkeypatch.setattr(JRenderer, "_ALPHA_ROUNDS", 2)
    jr, tr = _renderers(coherent=1)
    assert jr._alpha_rounds == tr._alpha_rounds == 2
    assert RayTraceRenderer(LaceScene("torch", opacity=False), width=8,
                            height=8, device="cpu")._alpha_rounds == 0
    _render_agrees(jr, tr, "GLAZE_ALPHA_ROUNDS=2")


def test_alpha_mask_env_tables_and_render_vs_jax(monkeypatch):
    """GLAZE_ALPHA_MASK=0: both flattens bake no cell masks (the tables
    are field for field glaze_tpu's), the port takes the opaque/alpha
    split and the renders agree."""
    from glaze_tpu.scene.flatten import flatten_scene
    from glaze_tpu_torch.render import integrator as ti
    from glaze_tpu_torch.scene.flatten import (
        device_scene_from_numpy,
        flatten_scene_np,
    )
    from torch_parity import jax_scene_to_numpy

    monkeypatch.setenv("GLAZE_ALPHA_MASK", "0")
    js, _, _ = flatten_scene(LaceScene("jax"))
    jf = jax_scene_to_numpy(js)
    tf, _, _ = flatten_scene_np(LaceScene("torch"))
    assert sorted(jf) == sorted(tf)
    for key in sorted(jf):
        a, b = np.asarray(jf[key]), np.asarray(tf[key])
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), key
    ts = device_scene_from_numpy(tf, "cpu")
    assert ts.bvh.tri.shape[1] == 9 and ts.bvh_alpha.tri.shape[1] == 9
    assert ts.alpha_attr_full is None and not ti._full_tree_masked(ts, 1)
    jr, tr = _renderers(coherent=1)
    assert tr.scene.alpha_attr_full is None and tr._alpha_rounds == 1
    _render_agrees(jr, tr, "GLAZE_ALPHA_MASK=0")


# ---------------------------------------------------------------------------
# the sampling switches, read at construction (a fresh interpreter each)

_SAMPLING_PROBE = """
import json, os, sys
import glaze_tpu_torch.scenes as ps
from glaze_tpu.render.renderer import RayTraceRenderer as JRenderer
from glaze_tpu_torch import cli
from glaze_tpu_torch.render.renderer import RayTraceRenderer

var, value, arg, flag, scene = sys.argv[1:6]
override = json.loads(arg)
os.environ[var] = value
os.environ["GLAZE_ADAPTIVE_TAU"] = "0.25"
os.environ["GLAZE_ADAPTIVE_MIN"] = "3"
out = {}

def attrs(r):
    return [r.samples_in_flight, r.sampler, bool(r.adaptive),
            r.adaptive_tau, r.adaptive_min]

for label, kw in (("env", {}), ("argument", override)):
    jr = JRenderer(ps.MatRowScene(), width=16, height=8, seed=3, **kw)
    tr = RayTraceRenderer(ps.MatRowScene(), width=16, height=8, seed=3,
                          device="cpu", **kw)
    out[label] = [attrs(jr), attrs(tr)]
argv = [scene, scene + ".png", "--res", "16x8", "--spp", "2", "--seed", "3",
        "--device", "cpu"]
for label, extra in (("cli_env", []), ("cli_flag", flag.split())):
    code, r, t = cli.run(argv + extra)
    out[label] = [code, attrs(r), t["launches"],
                  int(r._state.count.shape[0]), float(r._state.count.max())]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def sampling_scene(tmp_path_factory):
    import glaze_tpu_torch.scenes as ps

    path = tmp_path_factory.mktemp("env") / "row.glaze"
    ps.write_glaze(ps.MatRowScene(), str(path))
    return str(path)


@pytest.mark.parametrize("var,value,override", [
    ("GLAZE_SIF", "4", {"samples_in_flight": 1}),
    ("GLAZE_SAMPLER", "ld", {"sampler": "pcg"}),
    ("GLAZE_ADAPTIVE", "1", {"adaptive": False})])
def test_unported_env_refused(var, value, override, sampling_scene):
    """The sampling variables, once refused as not ported, act as in
    glaze_tpu: with the variable set, both renderers take it (and
    GLAZE_ADAPTIVE_TAU / _MIN); an argument overrides it in both; the CLI
    renders with it, and its flag overrides it. Under GLAZE_SIF=4 a
    two-sample render runs ceil(2 * 6 / 4) = 3 launches over 4 copies of
    the 128x16 padded grid."""
    env = {k: v for k, v in os.environ.items() if k not in VARS}
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in (env.get("PYTHONPATH"),) if p])
    env.setdefault("JAX_PLATFORMS", "cpu")
    flag = {"samples_in_flight": "--sif 1", "sampler": "--sampler pcg",
            "adaptive": "--adaptive off"}[next(iter(override))]
    res = subprocess.run(
        [sys.executable, "-c", _SAMPLING_PROBE, var, value,
         json.dumps(override), flag, sampling_scene],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    default = [1, "pcg", False, 0.25, 3.0]
    by_env = list(default)
    by_env[{"GLAZE_SIF": 0, "GLAZE_SAMPLER": 1, "GLAZE_ADAPTIVE": 2}[var]] = (
        {"GLAZE_SIF": 4, "GLAZE_SAMPLER": "ld", "GLAZE_ADAPTIVE": True}[var])
    assert out["env"] == [by_env, by_env]
    assert out["argument"] == [default, default]
    sif = by_env[0]
    launches = -(-12 // sif)
    assert out["cli_env"][:4] == [0, by_env, launches, 2048 * sif]
    if var == "GLAZE_ADAPTIVE":
        # the tile parked once its pixels had 3 launches
        assert 3.0 <= out["cli_env"][4] < launches
    else:
        assert out["cli_env"][4] == launches
    assert out["cli_flag"] == [0, default, 12, 2048, 12.0]
