"""glaze_tpu_torch and chip_smoke.py stand alone: no JAX, nothing of
glaze_tpu, and entry points that run on CUDA unless told otherwise."""

import ast
import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "glaze_tpu"}


def _port_sources():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "glaze_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
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


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_glaze_tpu_import(path):
    """Exact top-level names: 'glaze_tpu_torch' is allowed, 'glaze_tpu' is
    not (a prefix test would confuse the two)."""
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


@pytest.mark.parametrize("flags", [
    ["--mesh"], ["--checkpoint", "ck.npz"], ["--sif", "2"],
    ["--sampler", "ld"], ["--adaptive", "on"], ["--denoise"], ["--profile"],
])
def test_cli_rejects_unported_flags(flags, tmp_path, capsys):
    from glaze_tpu_torch import cli

    code = cli.main([str(tmp_path / "s.glaze"), str(tmp_path / "o.png"),
                     "--device", "cpu"] + flags)
    assert code == 2
    assert "not yet ported" in capsys.readouterr().err


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
