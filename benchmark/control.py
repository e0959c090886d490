"""The check's two readings on the chip, for setting its limits: the
program's sound runs and the control, on the same seeds in one process.

    python -m benchmark.control --workload <cell> --seeds 11,12,13 --seconds 10

For each seed it makes one run as ``benchmark.run`` does and prints the
numbers the check compares (the lower reading), then the reference's
replay of the same traffic computed in bfloat16 (:func:`reference.bf16`,
the control) compared with the float32 reference by the same numbers
(the upper reading). One JSON line a seed. The benchmark's own runs do not
run it.
"""

import argparse
import json
import sys

import torch

from benchmark import cells, drive, reference


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = cells.Cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        run, out, sound = drive.run_cell(cell, seed, args.seconds, False,
                                         device=args.device)
        dev = out["devices"][0]
        want = drive.reference_outputs(cell, run, out, dev)
        got = drive.reference_outputs(cell, run, out, dev,
                                      precision=reference.bf16)
        control = drive.compare(cell, got, want)
        print(json.dumps({
            "workload": cell.name, "seed": seed,
            "launches": run.launches, "frames": len(run.intervals),
            "sound": {k: v for k, (v, _) in sound.items()},
            "control": {k: v for k, (v, _) in control.items()}}),
            flush=True)
        del run, out, want, got
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
