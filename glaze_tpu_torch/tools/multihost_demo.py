"""Rehearses :mod:`glaze_tpu_torch.tools.pod_launch` on the CPU: several
processes render one image and resume it from their gathered checkpoint.

Run (it starts its own processes)::

    python -m glaze_tpu_torch.tools.multihost_demo [--nproc 2]

``--nproc`` pod_launch processes (CPU ranks on gloo, rendezvous through a
file in a temporary directory, so no port is taken) render the golden
scene at 64x32 for one sample with ``--checkpoint``; a second set of
processes resumes that checkpoint to two samples. Their final gathered
checkpoint must equal the CLI's straight two-sample render of the same
seed: count exact, and every float leaf within rtol 1e-5, atol 1e-6 (on the
CPU a lane may round an ulp apart at another position of a shorter
slice; on a card the slices are bit for bit). The counterpart of the JAX
package's ``tools/multihost_cpu_demo.py``.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

RES = "64x32"
SEED = "5"


def _pod(scene, out, ckpt, spp, nproc, store, timeout=300):
    """``nproc`` pod_launch processes on the CPU; raises if one fails (the
    others are killed rather than left waiting in a collective)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "glaze_tpu_torch.tools.pod_launch", scene, out,
         "--res", RES, "--spp", str(spp), "--seed", SEED, "--device", "cpu",
         "--coordinator", "file://" + store, "--num-processes", str(nproc),
         "--process-id", str(rank), "--checkpoint", ckpt],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(nproc)]
    deadline = time.monotonic() + timeout
    try:
        while time.monotonic() < deadline:
            rcs = [p.poll() for p in procs]
            if all(rc is not None for rc in rcs) or any(rcs):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        outs = [p.communicate(timeout=30)[0] for p in procs]
    rcs = [p.returncode for p in procs]
    if any(rcs):
        raise RuntimeError(f"pod_launch exit codes {rcs}:\n" + outs[0][-3000:])
    return outs[0]


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="multihost_demo", description=__doc__.split("\n")[0])
    ap.add_argument("--nproc", type=int, default=2)
    args = ap.parse_args(argv)

    import glaze_tpu_torch.scenes as ps
    from glaze_tpu_torch import cli

    with tempfile.TemporaryDirectory() as tmp:
        scene = os.path.join(tmp, "row.glaze")
        ps.write_glaze(ps.MatRowScene(), scene)
        ckpt = os.path.join(tmp, "pod.npz")
        out = os.path.join(tmp, "pod.png")
        _pod(scene, out, ckpt, 1, args.nproc, os.path.join(tmp, "store1"))
        log = _pod(scene, out, ckpt, 2, args.nproc,
                   os.path.join(tmp, "store2"))
        if "resumed" not in log:
            raise RuntimeError("the second run did not resume:\n" + log)
        ref = os.path.join(tmp, "ref.npz")
        code = cli.main([scene, os.path.join(tmp, "ref.png"), "--res", RES,
                         "--spp", "2", "--seed", SEED, "--device", "cpu",
                         "--checkpoint", ref])
        if code != 0 or not os.path.exists(out):
            raise RuntimeError(f"the CLI exited {code}")
        got, want = np.load(ckpt), np.load(ref)
        n = int(want["n_leaves"])
        worst = 0.0
        for i in range(n):
            a, b = got[f"leaf_{i}"], want[f"leaf_{i}"]
            if a.dtype.kind in "iu" or i == 12:  # path_no, count
                if not np.array_equal(a, b):
                    raise RuntimeError(f"leaf {i} differs")
            else:
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6,
                                           err_msg=f"leaf {i}")
                worst = max(worst, float(np.abs(a - b).max()))
        print(f"multihost demo OK: {args.nproc} processes rendered and "
              f"resumed the golden scene at {RES}, 2 spp, equal to the CLI's "
              f"render (max |d| {worst:.2e})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
