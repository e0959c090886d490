"""The TPU probe tools of ``tools/``, ported to the card.

Each is an entry point, ``python -m glaze_tpu_torch.tools.<name>``, that
runs on ``cuda`` unless ``--device cpu`` is given (no card: it raises):

- ``bench_mxu`` (T1): the fat-leaf drain on tensor cores, its agreement
  with exact Moller-Trumbore and its time per (row, leaf);
- ``bench_dot`` (T3a, T3b): a chain of dependent drain products at each
  precision, and the product with the full closest-hit resolve;
- ``exp_overhead`` (T2): the walk loop's cost per iteration, variants
  A-D, at packets of 2048 rays and of one warp;
- ``bench_bf16_slab`` (T4): the slab test's rate in f32 and packed bf16.

Beside them, ``pod_launch`` renders one image across processes (the
CLI's semantics on torch.distributed, one process per card) and
``multihost_demo`` rehearses it with CPU processes.

Their kernels are in ``csrc/probes.cu`` (wrappers:
:mod:`glaze_tpu_torch.tools.probes_cuda`); each tool module holds its
kernel's plain torch version, which the CPU takes.
"""
