"""Frozen copies of the port's plain render path: the benchmark's
reference. Nothing here imports glaze_tpu_torch, glaze_tpu or jax."""
