# Frozen copy of glaze_tpu_torch/scene/__init__.py for the benchmark's plain
# reference (benchmark/README.md): imports rewritten to benchmark.ref.
from benchmark.ref.scene.flatten import (
    DeviceScene,
    HostSceneData,
    device_scene_from_numpy,
    device_scene_to_numpy,
    flatten_scene,
)

__all__ = ["DeviceScene", "HostSceneData", "device_scene_from_numpy",
           "device_scene_to_numpy", "flatten_scene"]
