"""Background scene loading with progress (app/src/ui.rs:88-95 analogue).

The reference app loads scenes on a worker thread and feeds an mpsc
progress channel that drives a popup while the render loop keeps
presenting frames (`ui.rs` "Opening file..." + `viewport.rs` redraw).
The equivalent here: :class:`BackgroundSceneLoader` parses and
FORCE-DECODES every chunk of a `.glaze` (or convertible) file on a
worker thread — pure NumPy work, no torch — publishing (stage, fraction)
progress, and hands back a :class:`PreloadedScene` whose accessors
return the already-decoded data. The caller (app command loop / viewer
render thread) keeps drawing the old scene meanwhile and swaps via
``RayTraceRenderer.change_scene`` when ``done`` — only the device
upload + BVH build run on the render thread.
"""

from __future__ import annotations

import threading


class PreloadedScene:
    """ParsedScene duck type with every chunk decoded up front.

    ``update``/``serialize`` style calls forward to the underlying
    parsed object (scene save keeps working after a background load).
    """

    def __init__(self, parsed, progress=None):
        def report(stage, frac):
            if progress is not None:
                progress(stage, frac)

        vn = getattr(parsed, "vertices_np", None)
        report("vertices", 0.10)
        if vn is not None:
            self._vertices_np = vn()
            self._vertices = None
        else:
            self._vertices_np = None
            self._vertices = parsed.vertices()
        report("meshes", 0.45)
        self._meshes = parsed.meshes()
        self._transforms = parsed.transforms()
        self._instances = parsed.instances()
        self._cameras = parsed.cameras()
        report("textures", 0.55)
        self._textures = parsed.textures()  # per-mip PNG decode: the slow part
        report("materials", 0.90)
        self._materials = parsed.materials()
        self._lights = parsed.lights()
        self._meta = parsed.meta()
        self._parsed = parsed
        report("decoded", 0.95)

    # chunk accessors (ParsedScene trait surface, parser/mod.rs:294-323)
    def vertices(self):
        if self._vertices is None:
            # rebuild Vertex objects lazily from the bulk arrays (only
            # save paths need them)
            from glaze_tpu_torch.core import Vertex

            vv, vn, vt = self._vertices_np
            self._vertices = [Vertex(vv[i], vn[i], vt[i])
                              for i in range(len(vv))]
        return self._vertices

    def vertices_np(self):
        if self._vertices_np is None:
            import numpy as np

            vs = self._vertices
            self._vertices_np = (
                np.stack([v.vv for v in vs]) if vs else np.zeros((0, 3), np.float32),
                np.stack([v.vn for v in vs]) if vs else np.zeros((0, 3), np.float32),
                np.stack([v.vt for v in vs]) if vs else np.zeros((0, 2), np.float32),
            )
        return self._vertices_np

    def meshes(self):
        return self._meshes

    def transforms(self):
        return self._transforms

    def instances(self):
        return self._instances

    def cameras(self):
        return self._cameras

    def textures(self):
        return self._textures

    def materials(self):
        return self._materials

    def lights(self):
        return self._lights

    def meta(self):
        return self._meta

    def update(self, **kwargs):
        """In-place scene rewrite (ParsedScene::update) on the backing
        file; refreshes the preloaded copies that changed."""
        self._parsed.update(**kwargs)
        for key, attr in (("cameras", "_cameras"), ("materials", "_materials"),
                          ("lights", "_lights"), ("textures", "_textures"),
                          ("meta", "_meta")):
            if kwargs.get(key) is not None:
                setattr(self, attr, kwargs[key])


class BackgroundSceneLoader:
    """Worker-thread scene load with a polled progress snapshot.

    >>> ld = BackgroundSceneLoader("scene.glaze")
    >>> while not ld.done: render_a_frame(); print(ld.stage, ld.fraction)
    >>> renderer.change_scene(ld.result)   # raises if the load failed
    """

    def __init__(self, path: str):
        self.path = path
        self.stage = "opening"
        self.fraction = 0.0
        self.error: Exception | None = None
        self.result: PreloadedScene | None = None
        self.done = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _progress(self, stage: str, frac: float):
        self.stage = stage
        self.fraction = frac

    def _run(self):
        try:
            from glaze_tpu_torch.converter import ensure_glaze
            from glaze_tpu_torch.parser import parse

            self._progress("converting", 0.02)
            path = ensure_glaze(self.path)
            self._progress("parsing", 0.05)
            parsed = parse(path)
            self.result = PreloadedScene(parsed, self._progress)
            self._progress("ready", 1.0)
        except Exception as e:  # surface to the polling side
            self.error = e
            self.stage = "error"
        finally:
            self.done = True

    def join(self, timeout=None):
        self._thread.join(timeout)
        return self.done
