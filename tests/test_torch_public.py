"""The port's public surface, device instances and GLAZE_DEBUG, against
glaze_tpu's, on the CPU."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_all_matches_glaze_tpu_but_the_realtime_renderer():
    """The interactive renderer is ported too: the names are glaze_tpu's,
    RealtimeRenderer included."""
    import glaze_tpu
    import glaze_tpu_torch

    assert "RealtimeRenderer" in glaze_tpu_torch.__all__
    assert set(glaze_tpu_torch.__all__) == set(glaze_tpu.__all__)


@pytest.mark.parametrize("name", sorted(
    __import__("glaze_tpu_torch").__all__))
def test_exported_name_is_the_ports_own(name):
    """Each exported name resolves, to an object of glaze_tpu_torch (the
    lazy renderer names included), never to glaze_tpu's."""
    import glaze_tpu
    import glaze_tpu_torch

    obj = getattr(glaze_tpu_torch, name)
    assert obj.__module__.split(".")[0] == "glaze_tpu_torch"
    assert obj is not getattr(glaze_tpu, name)


def test_star_import_and_the_unported_realtime_renderer():
    """RealtimeRenderer, once refused here, resolves lazily: to the port's
    class, in a process where CUDA stays uninitialised."""
    import glaze_tpu_torch

    ns = {}
    exec("from glaze_tpu_torch import *", ns)
    assert {"RayTraceRenderer", "Integrator", "RealtimeRenderer",
            "parse"} <= set(ns)
    from glaze_tpu_torch.render.realtime import RealtimeRenderer

    assert glaze_tpu_torch.RealtimeRenderer is RealtimeRenderer
    with pytest.raises(AttributeError):
        glaze_tpu_torch.NoSuchName
    code = ("import sys, torch, glaze_tpu_torch as g\n"
            "assert 'glaze_tpu_torch.render.realtime' not in sys.modules\n"
            "cls = g.RealtimeRenderer\n"
            "assert cls.__module__ == 'glaze_tpu_torch.render.realtime'\n"
            "assert 'glaze_tpu' not in sys.modules\n"
            "print(torch.cuda.is_initialized())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


def test_import_does_not_initialise_cuda():
    code = ("import torch, glaze_tpu_torch as g\n"
            "from glaze_tpu_torch import RayTraceRenderer, Integrator, "
            "parse, Serializer, RayTraceInstance\n"
            "assert 'glaze_tpu' not in __import__('sys').modules\n"
            "print(torch.cuda.is_initialized())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


def test_instances(monkeypatch):
    """``new(device="cpu")`` gives a CPU instance; ``new()`` takes the
    card and is None where torch sees none (no CPU fallback)."""
    from glaze_tpu_torch import PresentInstance, RayTraceInstance

    inst = RayTraceInstance.new(device="cpu")
    assert inst.device == torch.device("cpu")
    assert (inst.info.platform, inst.info.device_kind, inst.info.index) == (
        "cpu", "cpu", 0)
    assert not inst.is_accelerated and inst.supports_raytrace()
    assert str(inst.info) == "cpu (cpu, cpu)"
    pres = PresentInstance.new("cpu")
    assert isinstance(pres, PresentInstance) and pres.supports_raytrace()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert RayTraceInstance.new() is None
    assert PresentInstance.new() is None
    assert RayTraceInstance.new("cuda:0") is None
    with pytest.raises(ValueError, match="unsupported"):
        RayTraceInstance("meta")


@pytest.mark.cuda
def test_instance_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from glaze_tpu_torch import RayTraceInstance

    inst = RayTraceInstance.new()
    assert inst.device == torch.device("cuda:0") and inst.is_accelerated
    assert inst.info.platform == "gpu"
    assert inst.info.name == torch.cuda.get_device_name(0)


# -- GLAZE_DEBUG -----------------------------------------------------------


@pytest.fixture
def debug_off(monkeypatch):
    """The NaN checks off for the test, and off again after it."""
    from glaze_tpu_torch.utils import runtime

    monkeypatch.setattr(runtime, "_debug_nans", False)
    monkeypatch.delenv("GLAZE_DEBUG", raising=False)
    return runtime


@pytest.mark.parametrize("env,force,expect", [
    (None, None, False), ("", None, False), ("0", None, False),
    ("1", None, True), ("yes", None, True), ("1", False, False),
    (None, True, True)])
def test_setup_debug_modes_reads_env(env, force, expect, debug_off,
                                     monkeypatch):
    """``GLAZE_DEBUG`` as glaze_tpu reads it: on for anything but "" or
    "0", ``force`` over the variable; it turns the checks on, never off
    (glaze_tpu's is only called here where it enables nothing)."""
    from glaze_tpu.utils.runtime import setup_debug_modes as jax_setup

    if env is not None:
        monkeypatch.setenv("GLAZE_DEBUG", env)
    assert debug_off.setup_debug_modes(force) is expect
    assert debug_off.debug_nans() is expect
    if not expect:
        assert jax_setup(force) is False


def test_check_nans_names_the_leaf_and_passes_inf():
    from glaze_tpu_torch.utils.runtime import check_nans

    ok = torch.tensor([1.0, float("inf"), -float("inf")])
    check_nans([("t", ok), ("tri", torch.tensor([1, 2]))], "launch 3")
    bad = torch.tensor([0.0, float("nan"), 2.0])
    with pytest.raises(FloatingPointError,
                       match=r"launch 3, leaf 'accum\[1\]' \(1 of 3"):
        check_nans([("t", ok), ("accum[1]", bad)], "launch 3")


def _small_renderer(**kw):
    import glaze_tpu_torch.scenes as ps
    from glaze_tpu_torch.render.renderer import RayTraceRenderer

    return RayTraceRenderer(ps.MatRowScene(), width=32, height=16, seed=7,
                            device="cpu", **kw)


def test_debug_nan_in_bsdf_raises_naming_the_launch(debug_off, monkeypatch):
    """A NaN injected into the bounce BSDF's value reaches the path state;
    with the checks on, draw raises at the first launch that holds it,
    naming the launch and the leaf."""
    from glaze_tpu_torch.render import bsdf

    real = bsdf.bsdf_sample
    calls = []

    def poisoned(*a, **k):
        wi, value, pdf = real(*a, **k)
        calls.append(1)
        if len(calls) == 3:  # the third launch's bounce
            value = torch.full_like(value, float("nan"))
        return wi, value, pdf

    monkeypatch.setattr(bsdf, "bsdf_sample", poisoned)
    debug_off.setup_debug_modes(force=True)
    r = _small_renderer()
    with pytest.raises(FloatingPointError,
                       match=r"launch 2, leaf 'importance'"):
        r.draw(1)


def test_debug_off_costs_nothing_and_changes_nothing(debug_off, monkeypatch):
    """Off, no check runs; on, a render without NaN is bit for bit the
    render with the checks off."""
    from glaze_tpu_torch.render import integrator
    from glaze_tpu_torch.render import renderer as rmod

    def never(*a, **k):
        raise AssertionError("NaN check ran with GLAZE_DEBUG off")

    with monkeypatch.context() as m:
        m.setattr(rmod, "check_nans", never)
        off = _small_renderer()
        off.draw(1)
    checked = []
    real = rmod.check_nans
    monkeypatch.setattr(rmod, "check_nans",
                        lambda leaves, where: (checked.append(where),
                                               real(leaves, where)))
    debug_off.setup_debug_modes(force=True)
    on = _small_renderer()
    on.draw(1)
    assert checked == [f"launch {k}" for k in range(6)]
    on.draw(1)  # the count goes on within one accumulation
    assert checked[-1] == "launch 11"
    on2 = _small_renderer()
    on2.draw(1)
    for (name, a), (_, b) in zip(integrator.named_leaves(off._state),
                                 integrator.named_leaves(on2._state)):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)


def test_cli_prints_the_debug_line(debug_off, monkeypatch, tmp_path, capsys):
    import glaze_tpu_torch.scenes as ps
    from glaze_tpu_torch import cli

    scene = tmp_path / "s.glaze"
    ps.write_glaze(ps.MatRowScene(), str(scene))
    args = [str(scene), str(tmp_path / "o.png"), "--res", "16x8", "--spp",
            "1", "-i", "direct", "--device", "cpu"]
    assert cli.main(args) == 0
    assert "GLAZE_DEBUG" not in capsys.readouterr().err
    monkeypatch.setenv("GLAZE_DEBUG", "1")
    assert cli.main(args) == 0
    assert ("GLAZE_DEBUG: NaN checks + runtime validation on"
            in capsys.readouterr().err)
    assert debug_off.debug_nans()
