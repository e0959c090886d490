# Frozen copy of glaze_tpu_torch/render/__init__.py for the benchmark's plain
# reference (benchmark/README.md): imports rewritten to benchmark.ref.
"""The wavefront path tracer: lights, BSDFs, the integrator and the
offline renderer."""
