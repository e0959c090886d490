# Frozen copy of glaze_tpu_torch/render/scheduler.py for the benchmark's plain
# reference (benchmark/README.md): imports rewritten to benchmark.ref.
"""Sub-pixel sample scheduler (port of WorkScheduler, raytracer.rs:1161-1206).

An endless iterator over sub-pixel jitter offsets: starting from the whole
pixel ((0,0),(1,1)) it repeatedly subdivides the area quadtree-style and
yields each cell's midpoint, so progressive sampling covers the pixel
footprint evenly at every prefix.
"""

from __future__ import annotations


class WorkScheduler:
    def __init__(self):
        self.current = [((0.0, 0.0), (1.0, 1.0))]
        self.next = []

    def rewind(self):
        self.__init__()

    def __iter__(self):
        return self

    def __next__(self):
        if self.current:
            a, b = self.current.pop()
            middle = ((a[0] + b[0]) / 2.0, (a[1] + b[1]) / 2.0)
            self.next.append((a, middle))
            self.next.append((middle, b))
            self.next.append(((middle[0], a[1]), (b[0], middle[1])))
            self.next.append(((a[0], middle[1]), (middle[0], b[1])))
            return middle
        self.current, self.next = self.next, []
        return self.__next__()

    def take(self, n: int):
        """Next n offsets as an (n, 2) float32 numpy array."""
        import numpy as np

        return np.asarray([next(self) for _ in range(n)], np.float32)
