"""One render across processes: glaze-cli's semantics on torch.distributed.

Run one process per card, under torch's launcher::

    torchrun --nproc-per-node 8 -m glaze_tpu_torch.tools.pod_launch \\
        scene.glaze out.png --res 1920x1080 --spp 256 \\
        [--checkpoint pod.npz --ckpt-every 32]

or name the rendezvous on each process (``--coordinator HOST:PORT
--num-processes N --process-id RANK``; a ``file:///shared/path`` URL
works too). Every process runs the same program with the same seeds: a
:class:`~glaze_tpu_torch.render.renderer.RayTraceRenderer` over a mesh of
its device, which holds and draws the process's slice of the lane axis
(:func:`glaze_tpu_torch.parallel.distributed.local_pixel_slice`), on the
device :func:`glaze_tpu_torch.parallel.distributed.placement` gives it (a
card of its own under NCCL, the cards in turn when ranks share them,
``--device cpu`` for CPU ranks); the launches need no traffic between
processes. The slices are gathered for the checkpoint, which rank 0
writes in the CLI's layout and every rank reads back on a resume, and for
the image, which rank 0 saves. One process alone renders over every card
of its host. The counterpart of the JAX package's
``tools/pod_launch.py``.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time


@contextlib.contextmanager
def gathered(renderer):
    """The renderer holding the whole image's state inside the block (every
    rank gathers; :func:`glaze_tpu_torch.parallel.distributed.gather_state`),
    its own lanes again after it."""
    from glaze_tpu_torch.parallel import distributed

    own = renderer._state
    renderer._state = distributed.gather_state(own, renderer.width,
                                               renderer.height)
    try:
        yield renderer
    finally:
        renderer._state = own


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="pod_launch", description=__doc__.split("\n")[0])
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--res", default="1920x1080")
    ap.add_argument("--spp", type=int, default=256)
    ap.add_argument("--integrator", choices=("direct", "pt"), default="pt")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (this rank's card, the default; no fallback) "
                         "or cpu")
    ap.add_argument("--coordinator", default=None,
                    help="rank 0's HOST:PORT, or a file:// rendezvous URL "
                         "(omit under torchrun)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--checkpoint", default=None,
                    help="gathered-state checkpoint (.npz); resumes if it "
                         "exists")
    ap.add_argument("--ckpt-every", type=int, default=32,
                    help="samples between checkpoint saves (default 32)")
    args = ap.parse_args(argv)

    import torch

    from glaze_tpu_torch.cli import scene_id
    from glaze_tpu_torch.converter import ensure_glaze
    from glaze_tpu_torch.parallel import distributed
    from glaze_tpu_torch.parser import parse
    from glaze_tpu_torch.render.renderer import Integrator, RayTraceRenderer
    from glaze_tpu_torch.utils import init_logging

    init_logging()
    distributed.init(args.coordinator, args.num_processes, args.process_id)
    rank = distributed.process_index()
    device = (torch.device("cpu") if args.device == "cpu"
              else distributed.local_device())
    if device.type != args.device:
        raise RuntimeError("CUDA is not available; pass --device cpu to "
                           "render on the CPU")
    if rank == 0:
        print(f"pod_launch: {distributed.process_count()} processes",
              file=sys.stderr)
    w, h = (int(v) for v in args.res.lower().split("x"))
    t0 = time.perf_counter()
    path = ensure_glaze(args.input)
    sid = scene_id(path) if args.checkpoint else ""
    integrator = (Integrator.DIRECT if args.integrator == "direct"
                  else Integrator.PATH_TRACE)
    r = RayTraceRenderer(parse(path), width=w, height=h,
                         integrator=integrator, seed=args.seed, device=device,
                         mesh="auto")
    if rank == 0:
        print(f"setup {time.perf_counter() - t0:.1f}s", file=sys.stderr)

    done = 0
    if args.checkpoint and os.path.exists(args.checkpoint):
        r.load_checkpoint(args.checkpoint, scene_id=sid)
        with gathered(r):
            done = min(r.completed_spp, args.spp)
        if rank == 0:
            print(f"resumed {args.checkpoint}: {done} spp done",
                  file=sys.stderr)

    def save_ckpt():
        if not args.checkpoint:
            return
        with gathered(r):  # every rank takes part in the gather
            if rank == 0:
                tmp = args.checkpoint + ".tmp.npz"
                r.save_checkpoint(tmp, scene_id=sid)
                os.replace(tmp, args.checkpoint)
        distributed.barrier()

    remaining = args.spp - done
    step = args.ckpt_every if args.checkpoint else max(remaining, 1)
    try:
        while remaining > 0:
            n = min(step, remaining)
            t0 = time.perf_counter()
            r.draw(n, return_image=False)
            remaining -= n
            done += n
            if rank == 0:
                rate = n / (time.perf_counter() - t0)
                print(f"{done}/{args.spp} spp ({rate:.2f} spp/s)",
                      file=sys.stderr)
            if remaining > 0:
                save_ckpt()
    except KeyboardInterrupt:
        save_ckpt()
        if rank == 0:
            print(f"interrupted at {done} spp: checkpoint saved",
                  file=sys.stderr)
        return 130
    save_ckpt()
    with gathered(r):
        if rank == 0:
            r.save(args.output)
            print(f"saved {args.output}", file=sys.stderr)
    distributed.barrier()
    distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
