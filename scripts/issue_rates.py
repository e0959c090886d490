"""The issue rate of each instruction class on this card.

Builds ``scripts/issue_rates.cu`` (one kernel per class: FADD, FMUL,
FFMA, FMNMX, FSETP, FSEL, MUFU, packed bf16 HADD2, HMUL2, HMNMX2, the
three-input VHMNMX and HSETP2, LOP3, F2FP, LDS.64; and mixed loops of two
classes) through ``glaze_tpu_torch.cuda_build`` into
``build/libglaze_rates.so``, runs each with 2,048 threads on every SM and
prints its rate: thread instructions per SM-clock (a packed bf16x2
instruction counts once) at the SM clock sampled while it ran and at
``clocks.max.sm``, rounded to its architectural class (128, 64, 32 or
16). A mixed loop shows whether its two classes issue to separate pipes
(the two rates add up to the issue rate) or to one (they share its
rate). Each loop's SASS is checked: the loop holds the named opcode as
often as the source says, and those opcodes make up most of it.

The rates and pipes that the port's bounds charge are
``glaze_tpu_torch.tools.common.RATES``; :func:`run_all` lists every class
that measures more than 5% above its charged rate and every mixed loop
that runs more than 5% faster than the charged pipes allow (a bound must
be a least time).

Usage: python scripts/issue_rates.py [--json PATH]   (on the card; exits
1 when a check fails)
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import math
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import torch  # noqa: E402

from glaze_tpu_torch import cuda_build  # noqa: E402
from glaze_tpu_torch.tools import common  # noqa: E402

SOURCE = os.path.join(HERE, "issue_rates.cu")
LIBRARY = "libglaze_rates.so"
THREADS = 256
BLOCKS_PER_SM = 8        # 2,048 threads on every SM
ARCH_CLASSES = (128, 64, 32, 16)
TOLERANCE = 1.05         # a measured rate may pass a charged one by 5%
LAUNCH_MS = 20.0         # one launch's length after calibration
RUN_MS = 600.0           # the timed launches of one loop, in all
MIN_TIMED_SHARE = 0.75   # the timed opcodes' share of their loop

# each kernel's instructions a thread and loop iteration, by class
# (scripts/issue_rates.cu: 8 chains x 16 steps; the predicate classes 96)
LOOPS = {
    "rate_fadd": {"FADD": 128},
    "rate_fmul": {"FMUL": 128},
    "rate_ffma": {"FFMA": 128},
    "rate_fmnmx": {"FMNMX": 128},
    "rate_fsetp": {"FSETP": 96},
    "rate_fsel": {"FSEL": 128},
    "rate_mufu": {"MUFU": 128},
    "rate_hadd2": {"HADD2": 128},
    "rate_hmul2": {"HMUL2": 128},
    "rate_hfma2": {"HFMA2": 128},
    "rate_hset2": {"HSET2": 128},
    "rate_hmnmx2": {"HMNMX2": 128},
    "rate_vhmnmx": {"VHMNMX": 128},
    "rate_hsetp2": {"HSETP2": 96},
    "rate_lop3": {"LOP3": 128},
    "rate_f2fp": {"F2FP": 128},
    "rate_lds64": {"LDS64": 128},
    "mix_fadd_fmnmx": {"FADD": 128, "FMNMX": 128},
    "mix_fmnmx_fsel": {"FMNMX": 128, "FSEL": 128},
    "mix_fmnmx_lop3": {"FMNMX": 128, "LOP3": 128},
    "mix_fmnmx_hmnmx2": {"FMNMX": 128, "HMNMX2": 128},
    "mix_hmnmx2_lop3": {"HMNMX2": 128, "LOP3": 128},
    "mix_hmnmx2_vhmnmx": {"HMNMX2": 128, "VHMNMX": 128},
    "mix_hmnmx2_hset2": {"HMNMX2": 128, "HSET2": 128},
    "mix_fmnmx_f2fp": {"FMNMX": 128, "F2FP": 128},
    "mix_fadd_hadd2": {"FADD": 128, "HADD2": 128},
    "mix_fsetp_fmnmx": {"FSETP": 96, "FMNMX": 128},
}
# the SASS opcodes of each class (by prefix: the name and, for the packed
# classes, the BF16_V2 modifier; LDS.64 by its width). ptxas issues about
# half of a loop's packed adds, products and fused multiply-adds as
# HFMA2.MMA, on the tensor pipe, so those count for the three classes.
MMA = "HFMA2.MMA.BF16_V2"
OPCODES = {"FADD": ("FADD",), "FMUL": ("FMUL",), "FFMA": ("FFMA",),
           "FMNMX": ("FMNMX",), "FSETP": ("FSETP",), "FSEL": ("FSEL",),
           "MUFU": ("MUFU.RSQ",), "HADD2": ("HADD2.BF16_V2", MMA),
           "HMUL2": ("HMUL2.BF16_V2", MMA), "HFMA2": ("HFMA2.BF16_V2", MMA),
           "HSET2": ("HSET2.BF16_V2",), "HMNMX2": ("HMNMX2.BF16_V2",),
           "VHMNMX": ("VHMNMX.BF16_V2",), "HSETP2": ("HSETP2.BF16_V2",),
           "LOP3": ("LOP3",), "F2FP": ("F2FP.BF16",), "LDS64": ("LDS.64",)}
# words of the kernels' input: 8 chain starts, operands a and b, a flag;
# f32 1.0 .. 1.875, a = 1.0, b = 0.5 for the f32 loops, which read them
# as floats; the bf16x2 loops read the same words as bit patterns
IN_WORDS = [0x3F800000 + (i << 20) for i in range(8)] + [
    0x3F800000, 0x3F000000, 1, 0, 0, 0, 0, 0]

_lib = None


def _sass_loops():
    spec = importlib.util.spec_from_file_location(
        "sass_loops", os.path.join(HERE, "sass_loops.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build():
    """Builds (if needed) and returns (library path, nvcc output)."""
    return cuda_build.build(SOURCE, LIBRARY)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build()[0])
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.glaze_rate_count.restype = i
        lib.glaze_rate_name.argtypes = [i]
        lib.glaze_rate_name.restype = ctypes.c_char_p
        lib.glaze_rate_run.argtypes = [i, p, i, p, i, p]
        lib.glaze_rate_run.restype = i
        lib.glaze_rate_attrs.argtypes = [i, p, p]
        lib.glaze_rate_attrs.restype = i
        lib.glaze_rate_error_string.argtypes = [i]
        lib.glaze_rate_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def kernel_names():
    lib = _load()
    return [lib.glaze_rate_name(k).decode() for k in range(lib.glaze_rate_count())]


def arch_class(rate):
    """The architectural rate (128, 64, 32 or 16) nearest ``rate`` on a
    log scale."""
    return min(ARCH_CLASSES, key=lambda c: abs(math.log2(rate / c)))


def sass_check(sass=None):
    """{kernel: {class: count in its loop, 'loop': instructions, 'share':
    the timed opcodes' share, 'others': the commonest other opcodes,
    'ok': bool}} from cuobjdump's listing of the library (or ``sass``).
    The loop is the backward branch whose body holds most of the timed
    opcodes."""
    sl = _sass_loops()
    if sass is None:
        sass = subprocess.run([sl.cuobjdump(), "-sass", build()[0]],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
    funcs = sl.functions(sass)
    out = {}
    for name, want in LOOPS.items():
        body = funcs.get(name)
        if body is None:
            out[name] = {"ok": False, "error": "not in the listing"}
            continue
        insns, found = sl.loops(body)
        best = None
        for first, last in found or [(0, len(insns) - 1)]:
            ops = [op for op, _ in insns[first:last + 1]]
            got = {c: sum(op.startswith(OPCODES[c]) for op in ops)
                   for c in want}
            if best is None or sum(got.values()) > sum(best[0].values()):
                best = (got, ops)
        got, ops = best
        timed = sum(got.values())
        others = {}
        for op in ops:
            if not any(op.startswith(OPCODES[c]) for c in want):
                others[op] = others.get(op, 0) + 1
        share = timed / max(len(ops), 1)
        mma = sum(op.startswith(MMA) for op in ops)
        out[name] = dict(got, loop=len(ops), share=share, mma=mma,
                         others=dict(sorted(others.items(),
                                            key=lambda kv: -kv[1])[:6]),
                         ok=got == want and share >= MIN_TIMED_SHARE)
    return out


def _timed(lib, which, words, out, iters, blocks, reps, clocks):
    """Milliseconds of ``reps`` launches, and the SM clocks nvidia-smi
    read while they ran (appended to ``clocks``)."""
    stream = torch.cuda.current_stream().cuda_stream
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        code = lib.glaze_rate_run(which, words.data_ptr(), iters,
                                  out.data_ptr(), blocks, stream)
        if code:
            raise RuntimeError(f"launch failed: CUDA error {code} "
                               f"({lib.glaze_rate_error_string(code).decode()})")
    end.record()
    # the launches run while nvidia-smi reads the clock; a reading that
    # ends after them is dropped
    while not end.query():
        mhz = common.sm_clocks_mhz()[0]
        if not end.query():
            clocks.append(mhz)
    end.synchronize()
    return start.elapsed_time(end)


def measure(name, sms=None, max_mhz=None):
    """One kernel's rates: its classes' instructions per SM-clock at the
    sampled clock and at ``clocks.max.sm``, with the run's numbers."""
    lib = _load()
    which = kernel_names().index(name)
    sms = sms or common.sm_count(torch.device("cuda"))
    max_mhz = max_mhz or common.max_sm_clock_mhz()
    blocks = sms * BLOCKS_PER_SM
    words = torch.tensor(IN_WORDS, dtype=torch.int64).to(torch.int32).cuda()
    out = torch.empty(blocks * THREADS, dtype=torch.int32, device="cuda")
    regs, local = ctypes.c_int(), ctypes.c_int()
    code = lib.glaze_rate_attrs(which, ctypes.byref(regs), ctypes.byref(local))
    if code:
        raise RuntimeError(f"{name}: attribute query failed ({code})")
    # the first launch loads the kernel; the second sizes the runs
    _timed(lib, which, words, out, 1, blocks, 1, [])
    probe = 256
    ms0 = _timed(lib, which, words, out, probe, blocks, 1, [])
    iters = max(probe, int(probe * LAUNCH_MS / max(ms0, 1e-3)))
    clocks = []
    reps = max(2, math.ceil(RUN_MS / LAUNCH_MS))
    for _ in range(3):
        ms = _timed(lib, which, words, out, iters, blocks, reps, clocks)
        if clocks:
            break
        reps *= 4  # nvidia-smi outlasted the run: run longer
    else:
        raise RuntimeError(f"{name}: no SM clock read while it ran "
                           f"({reps // 4} launches of {iters} iterations, "
                           f"{ms:.1f} ms)")
    sampled = sorted(clocks)[len(clocks) // 2]
    threads = blocks * THREADS
    per_class = {}
    for cls, n in LOOPS[name].items():
        total = n * iters * reps * threads
        per_class[cls] = {
            "per_sm_clock": total / (ms * 1e-3 * sampled * 1e6 * sms),
            "per_sm_clock_at_max": total / (ms * 1e-3 * max_mhz * 1e6 * sms)}
    return dict(kernel=name, ms=ms, iters=iters, reps=reps, blocks=blocks,
                registers=regs.value, local_bytes=local.value,
                sampled_mhz=sampled, clock_samples=len(clocks),
                max_mhz=max_mhz, classes=per_class)


def model_rate(counts):
    """Instructions per SM-clock that the charged rates and pipes allow a
    loop of ``counts`` (class -> instructions): its total over the larger
    of the issue term and the busiest pipe's term."""
    return sum(counts.values()) / common.ops_clocks(counts)[0]


def run_all(sass=None, report=None):
    """Every loop of LOOPS measured and checked (``report``, if given, is
    called with each result as it comes): returns (results by kernel,
    failures)."""
    sms = common.sm_count(torch.device("cuda"))
    max_mhz = common.max_sm_clock_mhz()
    checks = sass_check(sass)
    results, failures = {}, []
    for name in LOOPS:
        r = measure(name, sms, max_mhz)
        r["sass"] = checks[name]
        if not checks[name]["ok"]:
            failures.append(f"{name}: SASS {checks[name]}")
        if r["local_bytes"]:
            failures.append(f"{name}: {r['local_bytes']} local bytes")
        counts = LOOPS[name]
        if len(counts) == 1:
            (cls, c), = r["classes"].items()
            c["class"] = arch_class(c["per_sm_clock"])
            c["charged"] = common.RATES[cls][1]
            if c["per_sm_clock"] > TOLERANCE * c["charged"]:
                failures.append(f"{cls}: {c['per_sm_clock']:.1f} per "
                                f"SM-clock, charged {c['charged']}")
        else:
            total = sum(c["per_sm_clock"] for c in r["classes"].values())
            alone = {cls: results[f"rate_{cls.lower()}"]["classes"][cls][
                "per_sm_clock"] for cls in counts}
            n = sum(counts.values())
            # one pipe: the classes' times add; two: the larger one (or
            # the issue rate) sets the pace
            shared = n / sum(counts[c] / alone[c] for c in counts)
            apart = n / max(max(counts[c] / alone[c] for c in counts),
                            n / common.ISSUE_PER_SM_CLOCK)
            r.update(per_sm_clock=total, one_pipe=shared, two_pipes=apart,
                     overlap=abs(total - apart) < abs(total - shared),
                     charged=model_rate(counts))
            if total > TOLERANCE * r["charged"]:
                failures.append(f"{name}: {total:.1f} per SM-clock, the "
                                f"charged pipes allow {r['charged']:.1f}")
        results[name] = r
        if report is not None:
            report(r)
    return results, failures


def describe(r):
    """One line of a result of run_all."""
    head = (f"{r['kernel']}: {r['ms']:.1f} ms, clock {r['sampled_mhz']:.0f} "
            f"MHz sampled ({r['clock_samples']} samples; max "
            f"{r['max_mhz']:.0f}), {r['registers']} registers; SASS loop "
            f"{r['sass'].get('loop')} instructions, timed share "
            f"{r['sass'].get('share', 0):.2f}, others {r['sass'].get('others')}")
    if "per_sm_clock" in r:
        parts = ", ".join(f"{c} {v['per_sm_clock']:.1f}"
                          for c, v in r["classes"].items())
        verdict = "overlap" if r["overlap"] else "share a pipe"
        return (f"{head}; {parts}: {r['per_sm_clock']:.1f} per SM-clock "
                f"(one pipe {r['one_pipe']:.1f}, two pipes "
                f"{r['two_pipes']:.1f}: {verdict}; charged allow "
                f"{r['charged']:.1f})")
    (cls, c), = r["classes"].items()
    if r["sass"].get("mma"):
        head += f", {r['sass']['mma']} of them HFMA2.MMA"
    return (f"{head}; {cls} {c['per_sm_clock']:.2f} per SM-clock "
            f"({c['per_sm_clock_at_max']:.2f} at max clock), class "
            f"{c['class']}, charged {c['charged']}")


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        print("issue_rates: needs a CUDA device", file=sys.stderr)
        return 1
    print(common.card_line())
    results, failures = run_all(report=lambda r: print(describe(r),
                                                       flush=True))
    for f in failures:
        print(f"FAILED {f}")
    if "--json" in argv:
        path = argv[argv.index("--json") + 1]
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump({"card": common.card_line(), "results": results,
                       "failures": failures}, f, indent=1)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
