"""glaze-cli on PyTorch/CUDA: renders a scene to an image.

The input is a ``.glaze`` scene or any file the converter imports (OBJ,
glTF/GLB, FBX, COLLADA, X3D, VRML97, 3DS, PLY, STL), converted first to a
cached ``.glaze`` (:func:`glaze_tpu_torch.converter.ensure_glaze`); a
checkpoint's scene id is the sha256 of the ``.glaze`` that renders.

The flags and defaults of ``glaze_tpu/cli.py`` (input scene, output image,
``--res WxH`` 1920x1080, ``--spp`` 256, ``--integrator {direct,pt}``,
``--seed``, ``--coherent``, ``--sif``, ``--sampler``, ``--adaptive``,
``--checkpoint`` with ``--checkpoint-every``, ``--profile`` (the
profiler's trace, with the program's spans, and the recorder's) and
``--denoise`` and ``--mesh``), plus ``--device {cuda,cpu}`` (default
cuda). ``--mesh`` splits the pixel axis over every visible CUDA device
(with ``--device cpu``, a one-slot mesh on the CPU). The JAX package's
variables act as
they do in ``glaze_tpu`` (``GLAZE_DEBUG``, ``GLAZE_COHERENT``, ``GLAZE_SIF``,
``GLAZE_SAMPLER``, ``GLAZE_ADAPTIVE``, ``GLAZE_ADAPTIVE_TAU``,
``GLAZE_ADAPTIVE_MIN``, ``GLAZE_ALPHA_ROUNDS``, ``GLAZE_TILE``,
``GLAZE_ALPHA_MASK``, ``GLAZE_TREE``, ``GLAZE_LOG``), a flag over its
variable.

A ``--checkpoint`` holds the progressive state in the JAX package's
``.npz`` layout: a render resumes from it if it exists, saves it every
``--checkpoint-every`` samples and, on Ctrl-C, saves it and exits 130.

Usage: ``python -m glaze_tpu_torch.cli scene.glaze out.png --res 512x512 --spp 64``
"""

from __future__ import annotations

import argparse
import os
import sys

# the recorder's file beside the profiler's trace under --profile
SPANS_FILE = "spans.json"
# the CLI's phases: the spans that time them and the names they print under
PHASES = (("cli.parse", "parse"), ("cli.setup", "upload+bvh"),
          ("cli.render", "render"), ("cli.save", "save"))


def parse_resolution(s: str):
    try:
        w, h = s.lower().split("x")
        return int(w), int(h)
    except ValueError as e:
        raise argparse.ArgumentTypeError(f"bad resolution {s!r}, expected WxH") from e


def build_parser():
    p = argparse.ArgumentParser(
        prog="glaze-cli-torch",
        description="Renders a scene to an image (glaze on PyTorch/CUDA).",
    )
    p.add_argument("input", help="input scene (.glaze or a mesh format the "
                                 "converter imports)")
    p.add_argument("output", help="output image (.png/.jpg)")
    p.add_argument("-r", "--res", "--resolution", type=parse_resolution,
                   default=(1920, 1080), dest="res",
                   help="resolution WxH (default 1920x1080)")
    p.add_argument("-s", "--spp", type=int, default=256,
                   help="samples per pixel (default 256)")
    p.add_argument("-i", "--integrator", choices=("direct", "pt"), default="pt",
                   help="integrator (default pt)")
    p.add_argument("--seed", type=int, default=None, help="deterministic RNG seed")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="device to render on (default cuda; no fallback)")
    p.add_argument("--coherent", nargs="?", const="frame", default=None,
                   choices=("off", "frame", "tile"), metavar="off|frame|tile",
                   help="coherent sampling: pixels share RNG chains frame-wide "
                        "(the default) or per 2048-pixel tile; 'off' gives "
                        "every pixel its own chain")
    p.add_argument("--checkpoint", metavar="PATH",
                   help="progressive-state checkpoint (.npz): resume from PATH "
                        "if it exists, save every --checkpoint-every samples "
                        "and on Ctrl-C")
    p.add_argument("--checkpoint-every", type=int, default=32, metavar="SPP",
                   help="samples between checkpoint saves (default 32)")
    p.add_argument("--sif", type=int, default=None, metavar="N",
                   help="samples in flight per pixel (default env GLAZE_SIF "
                        "or 1): N path states advance per launch")
    p.add_argument("--sampler", choices=("pcg", "ld"), default=None,
                   help="sub-pixel sampler: pcg, the hash chain (default), or "
                        "ld, per-pixel Owen-scrambled Sobol (env "
                        "GLAZE_SAMPLER)")
    p.add_argument("--adaptive", choices=("on", "off"), default=None,
                   help="per-tile adaptive stopping: converged tiles stop "
                        "sampling (default off; env GLAZE_ADAPTIVE)")
    p.add_argument("--profile", nargs="?", const="glaze_profile", default=None,
                   metavar="DIR",
                   help="write a torch.profiler Chrome trace of the render, "
                        "with the program's spans, to DIR/trace.json, the "
                        "spans and counters of the whole run to "
                        "DIR/spans.json, and print per-phase wall-clock")
    p.add_argument(
        "--denoise", action="store_true",
        help="apply the edge-aware SVGF-style reconstruction filter to "
             "the SAVED image (render/denoise.py; display-time only — "
             "the accumulation itself stays unbiased, and the filter "
             "fades to identity as spp grows)")
    p.add_argument(
        "--mesh", action="store_true",
        help="split the render's pixel axis over every visible CUDA device "
             "(no traffic between devices while it renders; the same image "
             "as without it)")
    return p


def scene_id(path: str) -> str:
    """The sha256 of the scene file: the identity a checkpoint is held
    to."""
    import hashlib

    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def main(argv=None):
    return run(argv)[0]


def run(argv=None):
    """The CLI's work, recorded (:func:`glaze_tpu_torch.utils.recording`,
    the spans' rows kept only under ``--profile``): returns (exit code,
    renderer or None, timings in ms as a dict with ``setup``, ``render``,
    ``launches``, the launches this run made)."""
    from glaze_tpu_torch.utils import recording

    args = build_parser().parse_args(argv)
    with recording(rows=args.profile is not None) as rec:
        return _run(args, rec)


def _run(args, rec):
    from glaze_tpu_torch.converter import ensure_glaze
    from glaze_tpu_torch.parser import parse
    from glaze_tpu_torch.render.renderer import (
        Integrator,
        RayTraceRenderer,
        check_sampling,
    )
    from glaze_tpu_torch.utils import (
        init_logging,
        profiler_trace,
        setup_debug_modes,
        span,
    )

    init_logging()
    if setup_debug_modes():
        print("GLAZE_DEBUG: NaN checks + runtime validation on",
              file=sys.stderr)
    sampling = dict(samples_in_flight=args.sif, sampler=args.sampler,
                    adaptive=(None if args.adaptive is None
                              else args.adaptive == "on"))
    try:
        check_sampling(**sampling)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2, None, None
    with span("cli.parse"):
        scene_path = ensure_glaze(args.input)
        parsed = parse(scene_path)
    width, height = args.res
    integrator = (Integrator.DIRECT if args.integrator == "direct"
                  else Integrator.PATH_TRACE)
    with span("cli.setup"):
        renderer = RayTraceRenderer(parsed, width=width, height=height,
                                    integrator=integrator, seed=args.seed,
                                    coherent=args.coherent,
                                    device=args.device,
                                    mesh="auto" if args.mesh else None,
                                    **sampling)
    ms = _phase_ms(rec)
    setup_ms = ms["cli.parse"] + ms["cli.setup"]
    print(f"Setup time: {setup_ms:.0f}ms", file=sys.stderr)

    # the render phase: a resume's checkpoint load, the launches, the
    # checkpoints and, under --profile, the trace's export
    with span("cli.render"):
        done_spp = 0
        sid = scene_id(scene_path) if args.checkpoint else ""
        if args.checkpoint and os.path.exists(args.checkpoint):
            try:
                renderer.load_checkpoint(args.checkpoint, scene_id=sid)
            except ValueError as e:
                print(f"error: {e}", file=sys.stderr)
                return 2, None, None
            # the checkpoint's resolution, integrator and sif win over the
            # flags
            if (renderer.integrator is not integrator
                    or (renderer.width, renderer.height) != (width, height)):
                print(f"Resume overrides flags: {renderer.width}x"
                      f"{renderer.height} {renderer.integrator.name_str}",
                      file=sys.stderr)
            width, height = renderer.width, renderer.height
            done_spp = min(renderer.completed_spp, args.spp)
            print(f"Resumed {args.checkpoint}: {done_spp} spp done",
                  file=sys.stderr)

        total = renderer.launches(args.spp)
        base = renderer.launches(done_spp)

        def progress(done):
            pct = min(100.0, 100.0 * (base + done) / max(total, 1))
            print(f"\rRendering... {pct:5.1f}%", end="", file=sys.stderr,
                  flush=True)

        def save_checkpoint():
            # atomic: np.savez appends .npz to a name without it, so keep
            # the suffix and rename over the target
            tmp = args.checkpoint + ".tmp.npz"
            renderer.save_checkpoint(tmp, scene_id=sid)
            os.replace(tmp, args.checkpoint)

        with profiler_trace(args.profile or "",
                            enabled=args.profile is not None):
            remaining = args.spp - done_spp
            step = args.checkpoint_every if args.checkpoint else remaining
            # whole sif groups per chunk: draw(n) runs ceil(n * steps / sif)
            # launches, so other chunk sizes would sum past launches(spp)
            sif = renderer.samples_in_flight
            step = -(-max(step, 1) // sif) * sif
            try:
                while remaining > 0:
                    n = min(step, remaining)
                    renderer.draw(n, progress, return_image=False)
                    remaining -= n
                    base = renderer.launches(args.spp - remaining)
                    if args.checkpoint and remaining > 0:
                        save_checkpoint()
            except KeyboardInterrupt:
                if args.checkpoint:
                    save_checkpoint()
                    print(f"\nInterrupted: checkpoint saved to "
                          f"{args.checkpoint}", file=sys.stderr)
                    return 130, renderer, None
                raise
            if args.checkpoint:
                save_checkpoint()
    print(file=sys.stderr)
    render_ms = _phase_ms(rec)["cli.render"]
    launches = total - renderer.launches(done_spp)
    # rays traced this run: launches x sif path states per pixel
    rays = width * height * renderer.samples_in_flight * launches
    print(f"Render time: {render_ms:.0f}ms "
          f"({rays / max(render_ms, 1e-9) / 1e3:.1f} Mrays/s, "
          f"{render_ms / max(launches, 1):.1f} ms/launch)", file=sys.stderr)
    # display-time only: the accumulation (and any checkpoint) is saved
    # raw; the filter is applied once, to the written image
    renderer.denoise = args.denoise
    with span("cli.save"):
        renderer.save(args.output)
    if args.profile is not None:
        ms = _phase_ms(rec)
        phases = "  ".join(f"{label}={ms[name]:.0f}ms"
                           for name, label in PHASES)
        print(f"Phases: {phases}", file=sys.stderr)
        rec.export(os.path.join(args.profile, SPANS_FILE))
        print(f"Profile trace written to {args.profile}/", file=sys.stderr)
    print(f"Saved {args.output}", file=sys.stderr)
    return 0, renderer, {"setup": setup_ms, "render": render_ms,
                         "launches": launches}


def _phase_ms(rec) -> dict:
    """Milliseconds of each of the CLI's phase spans so far."""
    spans = rec.summary()["spans"]
    return {name: spans[name]["total_s"] * 1e3 if name in spans else 0.0
            for name, _ in PHASES}


if __name__ == "__main__":
    sys.exit(main())
