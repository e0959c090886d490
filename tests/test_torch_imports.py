"""glaze_tpu_torch and chip_smoke.py stand alone: no JAX, nothing of
glaze_tpu, and entry points that run on CUDA unless told otherwise."""

import ast
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "glaze_tpu", "tools"}


def _port_sources():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for top in ("glaze_tpu_torch", "scripts"):
        for dirpath, _, names in os.walk(os.path.join(ROOT, top)):
            files += [os.path.join(dirpath, n) for n in names
                      if n.endswith(".py")]
    return sorted(files)


def _imported_roots(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module.split(".")[0]


def test_port_sources_found():
    files = _port_sources()
    assert len(files) > 30
    assert any(f.endswith(os.path.join("accel", "traverse_cuda.py")) for f in files)
    assert any(f.endswith(os.path.join("tools", "probes_cuda.py")) for f in files)
    for mod in (("ops", "sobol.py"), ("utils", "log.py"),
                ("utils", "runtime.py"), ("render", "denoise.py"),
                ("scripts", "issue_rates.py"),
                ("glaze_tpu_torch", "converter.py"),
                ("glaze_tpu_torch", "fbx.py"),
                ("glaze_tpu_torch", "instance.py"),
                ("glaze_tpu_torch", "loader.py"),
                ("glaze_tpu_torch", "app.py"),
                ("glaze_tpu_torch", "viewer.py"),
                ("glaze_tpu_torch", "ui.py"),
                ("render", "realtime.py"), ("render", "preview.py"),
                ("parallel", "mesh.py"), ("parallel", "distributed.py")):
        assert any(f.endswith(os.path.join(*mod)) for f in files), mod


@pytest.mark.parametrize("source,bad", [
    ("import tools.bench_mxu\n", "tools"),
    ("from tools import exp_overhead\n", "tools"),
    ("from glaze_tpu_torch.tools import bench_mxu\n", None),
    ("from . import common\n", None),
])
def test_forbidden_roots_cover_the_tpu_tools(source, bad, tmp_path):
    """The import walk flags the TPU tools' package and not the port's own
    glaze_tpu_torch.tools."""
    path = tmp_path / "m.py"
    path.write_text(source)
    roots = [name for _, name in _imported_roots(str(path))]
    assert [r for r in roots if r in FORBIDDEN] == ([bad] if bad else [])


# each tool at a size the CPU runs in seconds
TOOL_ARGS = {
    "bench_mxu": ["16", "highest"],
    "bench_dot": ["--reps", "1"],
    "exp_overhead": ["--rays", "2048", "D"],
    "bench_bf16_slab": ["--iters", "1"],
}


@pytest.mark.parametrize("tool", sorted(TOOL_ARGS))
def test_tool_entry_points_need_cuda_unless_cpu(tool, monkeypatch, capsys):
    """python -m glaze_tpu_torch.tools.<tool> runs on cuda by default and
    raises without it; --device cpu runs the plain versions."""
    import importlib

    mod = importlib.import_module(f"glaze_tpu_torch.tools.{tool}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(TOOL_ARGS[tool])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(TOOL_ARGS[tool] + ["--device", "cuda"])
    assert mod.main(TOOL_ARGS[tool] + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "not measured" in out or "hit agree" in out


def test_probe_wrappers_refuse_cpu_tensors():
    """The probe kernels' wrappers launch or raise: a CPU tensor is an
    error there (the tools choose the plain version before), and no launch
    is counted."""
    import numpy as np

    from glaze_tpu_torch.accel import build_bvh
    from glaze_tpu_torch.tools import probes_cuda as pc

    before = {fn.__name__: fn.launches for fn in pc.KERNEL_WRAPPERS}
    mats = torch.zeros((16, 128))
    with pytest.raises(ValueError, match="CUDA"):
        pc.fat_drain(mats, torch.zeros((1, 3)), torch.zeros(4, dtype=torch.int32),
                     (torch.zeros(128),) * 3, (torch.ones(128),) * 3, 16)
    with pytest.raises(ValueError, match="CUDA"):
        pc.resolve_chain(mats, torch.zeros((16, 128)), 16, 4)
    with pytest.raises(ValueError, match="CUDA"):
        pc.dot_chain(mats, torch.zeros((16, 128)), "highest", 4)
    tri = np.asarray([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]], np.float32)
    bvh, _ = build_bvh(tri, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        pc.walk_overhead(bvh.nodes16, bvh.tri8, bvh.n_nodes,
                         (torch.zeros(32),) * 3, (torch.ones(32),) * 3, "A", 32)
    with pytest.raises(ValueError, match="CUDA"):
        pc.slab_rate(torch.zeros((2, 128)), torch.ones((2, 128)),
                     torch.zeros((64, 128)), 4)
    assert {fn.__name__: fn.launches for fn in pc.KERNEL_WRAPPERS} == before


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_glaze_tpu_import(path):
    """Exact top-level names: 'glaze_tpu_torch' is allowed, 'glaze_tpu' is
    not (a prefix test would confuse the two), nor the TPU tools' package
    'tools' (glaze_tpu_torch.tools keeps its own copies)."""
    bad = [(line, name) for line, name in _imported_roots(path)
           if name in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_resolve_device_refuses_missing_cuda(monkeypatch):
    from glaze_tpu_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        resolve_device(None)  # the default is cuda, never a CPU fallback
    assert resolve_device("cpu") == torch.device("cpu")


def test_renderer_cuda_raises_without_cuda(monkeypatch):
    import glaze_tpu_torch.scenes as ps
    from glaze_tpu_torch.render.renderer import RayTraceRenderer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        RayTraceRenderer(ps.MatRowScene(), width=32, height=16, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        RayTraceRenderer(ps.MatRowScene(), width=32, height=16)


def test_scene_upload_defaults_to_cuda(monkeypatch):
    import glaze_tpu_torch.scenes as ps
    from glaze_tpu_torch.scene import flatten_scene

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        flatten_scene(ps.MatRowScene())
    scene, _, _ = flatten_scene(ps.MatRowScene(), "cpu")
    assert scene.device == torch.device("cpu")


def test_cli_default_device_raises_without_cuda(monkeypatch, tmp_path):
    import glaze_tpu_torch.scenes as ps
    from glaze_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene = tmp_path / "s.glaze"
    ps.write_glaze(ps.MatRowScene(), str(scene))
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main([str(scene), str(tmp_path / "o.png"), "--res", "32x16",
                  "--spp", "1"])


@pytest.mark.parametrize("front", ["app", "viewer"])
def test_app_and_viewer_default_device_raises_without_cuda(front, monkeypatch,
                                                           tmp_path):
    """python -m glaze_tpu_torch.app / .viewer render on cuda unless given
    --device cpu: without a card their main raises before anything
    renders (the viewer binds no port)."""
    import importlib

    import glaze_tpu_torch.scenes as ps

    mod = importlib.import_module(f"glaze_tpu_torch.{front}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene = tmp_path / "s.glaze"
    ps.write_glaze(ps.MatRowScene(), str(scene))
    args = [str(scene), "--res", "16x8"]
    args += (["--out", str(tmp_path / "v.png")] if front == "app"
             else ["--port", "0"])
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main(args)
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main(args + ["--device", "cuda"])
    assert not (tmp_path / "v.png").exists()


@pytest.mark.parametrize("flags", [["--mesh"], ["--mesh", "--denoise"]])
def test_cli_rejects_unported_flags(flags, tmp_path, capsys):
    """--mesh, refused before it was ported, renders (also beside
    --denoise, glaze_tpu's ``--mesh --denoise`` render): with --device cpu
    on a one-slot mesh of the CPU; without --device it needs a card."""
    import glaze_tpu_torch.scenes as ps
    from glaze_tpu_torch import cli

    scene = tmp_path / "s.glaze"
    ps.write_glaze(ps.MatRowScene(), str(scene))
    code, r, _ = cli.run([str(scene), str(tmp_path / "o.png"), "--device",
                          "cpu", "--res", "16x8", "--spp", "1", "-i",
                          "direct"] + flags)
    assert code == 0 and (tmp_path / "o.png").exists()
    assert r._mesh is not None and r._mesh.size == 1
    assert "not yet ported" not in capsys.readouterr().err


def test_parallel_imports_without_cuda_or_jax():
    """glaze_tpu_torch.parallel imports no JAX and initialises no CUDA;
    make_mesh() without a card raises (no CPU fallback)."""
    code = ("import sys, torch\n"
            "import glaze_tpu_torch.parallel as p\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "print(torch.cuda.is_initialized())\n"
            "torch.cuda.is_available = lambda: False\n"
            "try:\n"
            "    p.make_mesh()\n"
            "except RuntimeError as e:\n"
            "    print('raised', 'CUDA' in str(e))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "raised", "True"]


@pytest.mark.parametrize("flags", [
    ["--checkpoint", "ck.npz"], ["--sif", "2"], ["--sampler", "ld"],
    ["--adaptive", "on"], ["--profile", "prof"], ["--denoise"],
])
def test_cli_accepts_ported_flags(flags, tmp_path, capsys):
    """The options that this CLI refused before they were ported render a
    PNG on the CPU (the DIRECT integrator, one sample of 16x8)."""
    import glaze_tpu_torch.scenes as ps
    from glaze_tpu_torch import cli

    scene = tmp_path / "s.glaze"
    ps.write_glaze(ps.MatRowScene(), str(scene))
    flags = [str(tmp_path / f) if f.endswith((".npz", "prof")) else f
             for f in flags]
    code = cli.main([str(scene), str(tmp_path / "o.png"), "--device", "cpu",
                     "--res", "16x8", "--spp", "2", "-i", "direct"] + flags)
    assert code == 0 and (tmp_path / "o.png").exists()
    assert "not yet ported" not in capsys.readouterr().err


def test_traverse_wrappers_refuse_cpu_tensors():
    """The kernel wrappers launch or raise: CPU rays are an error there,
    not a silent plain-version fallback."""
    import numpy as np

    from glaze_tpu_torch.accel import build_bvh, traverse_cuda

    tri = np.asarray([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]], np.float32)
    bvh, _ = build_bvh(tri, "cpu")
    o3 = tuple(torch.zeros(4) for _ in range(3))
    d3 = (torch.zeros(4), torch.zeros(4), torch.ones(4))
    before = traverse_cuda.closest_hit_soa.launches
    with pytest.raises(ValueError, match="CUDA"):
        traverse_cuda.closest_hit_soa(bvh, o3, d3)
    with pytest.raises(ValueError, match="CUDA"):
        traverse_cuda.any_hit_soa(bvh, o3, d3, torch.ones(4))
    assert traverse_cuda.closest_hit_soa.launches == before


@pytest.mark.parametrize("size", [(32, 16), (100, 37)])
def test_pixel_layout_built_on_the_scene_device(size, monkeypatch):
    """The launch's pixel coordinates and the display unswizzle run on the
    render's device: no host-built table crosses to it, and only the
    cropped (H, W, 3) image crosses back."""
    import numpy as np

    from glaze_tpu_torch.render import integrator as ti

    w, h = size
    ref_px, ref_py = ti.pixel_coords_np(w, h)
    p = ref_px.shape[0]
    rng = np.random.default_rng(60)
    state = ti.init_state(w, h, "cpu")._replace(
        accum=tuple(torch.from_numpy(rng.uniform(0, 4, p).astype(np.float32))
                    for _ in range(3)),
        count=torch.full((p,), 2.0))
    # the host image the display conversion must produce
    img = ti._fold_display(state.accum, state.count, 1.0).numpy()
    want = np.zeros((ref_py.max() + 1, ref_px.max() + 1, 3), np.uint8)
    want[ref_py, ref_px] = img
    want = want[:h, :w]

    def no_host_table(*a, **k):
        raise AssertionError("built on the host")

    monkeypatch.setattr(ti, "pixel_coords_np", no_host_table)
    monkeypatch.setattr(torch, "from_numpy", no_host_table)
    px, py = ti.pixel_coords(w, h, "cpu")
    assert px.dtype == torch.float32 and px.device.type == "cpu"
    assert np.array_equal(px.numpy(), ref_px) and np.array_equal(py.numpy(), ref_py)
    crossed = []
    orig_cpu = torch.Tensor.cpu

    def spy_cpu(self, *a, **k):
        crossed.append(tuple(self.shape))
        return orig_cpu(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "cpu", spy_cpu)
    got = ti.render_image(state, 1.0, w, h)
    assert crossed == [(h, w, 3)]
    assert got.shape == (h, w, 3) and np.array_equal(got, want)
