"""glaze-cli on PyTorch/CUDA: renders a .glaze scene to an image.

The flags and defaults of ``glaze_tpu/cli.py`` (input scene, output image,
``--res WxH`` 1920x1080, ``--spp`` 256, ``--integrator {direct,pt}``,
``--seed``, ``--coherent``), plus ``--device {cuda,cpu}`` (default cuda).
Flags whose features are not ported yet exit with an error, and so do the
JAX package's variables that ask for them where no flag overrides them
(``GLAZE_SIF``, ``GLAZE_SAMPLER=ld``, ``GLAZE_ADAPTIVE=1``). The variables
of ported features (``GLAZE_COHERENT``, ``GLAZE_ALPHA_ROUNDS``,
``GLAZE_TILE``, ``GLAZE_ALPHA_MASK``, ``GLAZE_TREE``) act as they do in
``glaze_tpu``.

Usage: ``python -m glaze_tpu_torch.cli scene.glaze out.png --res 512x512 --spp 64``
"""

from __future__ import annotations

import argparse
import sys
import time

NOT_PORTED = "not yet ported to glaze_tpu_torch"


def parse_resolution(s: str):
    try:
        w, h = s.lower().split("x")
        return int(w), int(h)
    except ValueError as e:
        raise argparse.ArgumentTypeError(f"bad resolution {s!r}, expected WxH") from e


def build_parser():
    p = argparse.ArgumentParser(
        prog="glaze-cli-torch",
        description="Renders a .glaze scene to an image (glaze on PyTorch/CUDA).",
    )
    p.add_argument("input", help="input .glaze scene")
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
    # accepted for compatibility with glaze_tpu's CLI; each is rejected
    # below until its feature is ported
    p.add_argument("--mesh", action="store_true", help=NOT_PORTED)
    p.add_argument("--checkpoint", metavar="PATH", help=NOT_PORTED)
    p.add_argument("--checkpoint-every", type=int, default=32, metavar="SPP",
                   help=NOT_PORTED)
    p.add_argument("--sif", type=int, default=None, metavar="N",
                   help="samples in flight per pixel: only 1 is ported")
    p.add_argument("--sampler", choices=("pcg", "ld"), default=None,
                   help="sub-pixel sampler: only pcg is ported")
    p.add_argument("--adaptive", choices=("on", "off"), default=None,
                   help="per-tile adaptive stopping: only off is ported")
    p.add_argument("--denoise", action="store_true", help=NOT_PORTED)
    p.add_argument("--profile", nargs="?", const="glaze_profile", default=None,
                   metavar="DIR", help=NOT_PORTED)
    return p


def _unported_flag(args):
    if args.mesh:
        return "--mesh"
    if args.checkpoint:
        return "--checkpoint"
    if args.sif not in (None, 1):
        return "--sif > 1"
    if args.sampler == "ld":
        return "--sampler ld"
    if args.adaptive == "on":
        return "--adaptive on"
    if args.denoise:
        return "--denoise"
    if args.profile is not None:
        return "--profile"
    return None


def main(argv=None):
    return run(argv)[0]


def run(argv=None):
    """The CLI's work: returns (exit code, renderer or None, timings in
    ms as a dict with ``setup``, ``render``, ``launches``)."""
    args = build_parser().parse_args(argv)
    flag = _unported_flag(args)
    if flag is not None:
        print(f"error: {flag} is {NOT_PORTED}", file=sys.stderr)
        return 2, None, None

    from glaze_tpu_torch.parser import converted_file, parse
    from glaze_tpu_torch.render.renderer import (
        Integrator,
        RayTraceRenderer,
        check_sampling,
    )

    sampling = dict(samples_in_flight=args.sif, sampler=args.sampler,
                    adaptive=(None if args.adaptive is None
                              else args.adaptive == "on"))
    try:
        check_sampling(**sampling)
    except NotImplementedError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2, None, None
    if not converted_file(args.input):
        print(f"error: {args.input!r} is not a .glaze scene (the converter "
              f"is {NOT_PORTED})", file=sys.stderr)
        return 2, None, None
    t0 = time.perf_counter()
    parsed = parse(args.input)
    width, height = args.res
    integrator = (Integrator.DIRECT if args.integrator == "direct"
                  else Integrator.PATH_TRACE)
    renderer = RayTraceRenderer(parsed, width=width, height=height,
                                integrator=integrator, seed=args.seed,
                                coherent=args.coherent, device=args.device,
                                **sampling)
    setup_ms = (time.perf_counter() - t0) * 1000.0
    print(f"Setup time: {setup_ms:.0f}ms", file=sys.stderr)

    total = args.spp * integrator.steps_per_sample

    def progress(done):
        pct = min(100.0, 100.0 * done / max(total, 1))
        print(f"\rRendering... {pct:5.1f}%", end="", file=sys.stderr, flush=True)

    t1 = time.perf_counter()
    renderer.draw(args.spp, progress, return_image=False)
    render_ms = (time.perf_counter() - t1) * 1000.0
    print(file=sys.stderr)
    rays = width * height * total
    print(f"Render time: {render_ms:.0f}ms "
          f"({rays / max(render_ms, 1e-9) / 1e3:.1f} Mrays/s, "
          f"{render_ms / max(total, 1):.1f} ms/launch)", file=sys.stderr)
    renderer.save(args.output)
    print(f"Saved {args.output}", file=sys.stderr)
    return 0, renderer, {"setup": setup_ms, "render": render_ms,
                         "launches": total}


if __name__ == "__main__":
    sys.exit(main())
