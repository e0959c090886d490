"""Device instances (port of lib/src/vulkan/instance.rs) on torch devices.

The reference's ``RayTraceInstance`` wraps "find a GPU with ray-tracing
support, else None" (instance.rs:339-450) and ``PresentInstance`` adds a
window surface (instance.rs:106-310). Here an instance holds a torch
device and the ``DeviceInfo`` the reference's stats window shows
(device.rs:403-448). ``new()`` takes ``cuda:0`` and returns None where
torch sees no card: the reference's ``Option``, with no CPU fallback.
``new(device="cpu")`` asks for the CPU explicitly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass
class DeviceInfo:
    """Name/platform/driver info (device.rs:403-448 equivalent)."""

    name: str
    platform: str
    device_kind: str
    index: int

    def __str__(self):
        return f"{self.name} ({self.platform}, {self.device_kind})"


def _device_info(device: torch.device) -> DeviceInfo:
    if device.type == "cuda":
        index = device.index if device.index is not None else 0
        major, minor = torch.cuda.get_device_capability(index)
        return DeviceInfo(name=torch.cuda.get_device_name(index),
                          platform="gpu", device_kind=f"sm_{major}{minor}",
                          index=index)
    return DeviceInfo(name="cpu", platform="cpu", device_kind="cpu", index=0)


class RayTraceInstance:
    """Headless compute instance on one torch device."""

    def __init__(self, device):
        self.device = torch.device(device)
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {str(self.device)!r}: "
                             "expected cuda or cpu")
        self.info = _device_info(self.device)

    @classmethod
    def new(cls, device=None) -> Optional["RayTraceInstance"]:
        """An instance on ``device`` (default ``cuda:0``), or None when a
        CUDA device is asked for and torch sees no card."""
        dev = torch.device("cuda:0" if device is None else device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            return None
        return cls(dev)

    def supports_raytrace(self) -> bool:
        return True

    @property
    def is_accelerated(self) -> bool:
        return self.info.platform != "cpu"


class PresentInstance(RayTraceInstance):
    """Instance for interactive use. ``supports_raytrace`` stays True: the
    wavefront tracer runs on either device."""
