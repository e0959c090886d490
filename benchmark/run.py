"""The benchmark's one command:

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout on a machine with the cards the cell asks
for. It prints the checked numbers beside their limits as the last lines
of standard error, and as the last line of standard output one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``
and, traced, ``breakdown``, and last ``checks``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

# what no process of the benchmark may load: JAX and the JAX package,
# compared by whole top-level module names
FORBIDDEN = ("jax", "jaxlib", "flax", "glaze_tpu")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchmark import cells

    cell = cells.Cell(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"error: {args.workload} needs {cell.chips} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from benchmark import drive

    run, out, checks = drive.run_cell(cell, args.seed, args.seconds,
                                      bool(args.trace), device="cuda",
                                      t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"error: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    result = {
        "correct": drive.correct(checks),
        "attempted": run.attempted,
        "failed": 0,
        "metrics": drive.metric_values(cell, run, bool(args.trace)),
        "device": drive.device_info(out, run, cell.chips),
    }
    if run.trace is not None:
        result["breakdown"] = run.trace.breakdown
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    print(f"seconds: set-up {run.setup_s:.2f}, window {run.window_s:.2f}, "
          f"check {run.check_s:.2f}", file=sys.stderr)
    if run.intervals:
        import numpy as np

        q = np.percentile(np.asarray(run.intervals) * 1e3, [50, 90, 95, 99])
        print("frame ms p50/p90/p95/p99: "
              + " ".join(f"{v:.1f}" for v in q), file=sys.stderr)
    for k, (v, lim) in checks.items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
