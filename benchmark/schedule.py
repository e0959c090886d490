"""The interactive traffic: a viewer session drawn from the seed.

A session alternates camera drags and stills. Each cycle holds one drag
and one still of every length in ``segment_frames``, in an order the seed
shuffles, so every seed asks for the same frames of each kind. A drag
frame strafes by ``strafe_m`` and turns by ``look_rad`` (the sign flips
from one drag to the next, so the camera stays in the scene); a still
frame moves nothing. Every ``edit_every`` frames one live edit lands: a
material's colour or roughness, or a light's intensity or colour, cycling
through those kinds, with values drawn from the seed. Opacity maps are
never edited. The warm-up frames come first: ``warmup`` lists them as
``drag``, ``still`` and ``edit`` entries.

Frames are plain dicts (``strafe``, ``look``, ``edit``); an edit is
``(kind, id, field, value)`` against the scene's own material and light
lists, applied on either side by :func:`apply_edit`.
"""

from __future__ import annotations

import copy

import numpy as np

# MaterialType values that take a diffuse colour / a roughness
# (glaze_tpu_torch.core.material: FLAT, LAMBERT, UBER / METAL, FROSTED, UBER)
_HAS_DIFFUSE = {0, 1, 6}
_HAS_ROUGHNESS = {4, 5, 6}
# LightType values whose intensity / colour an edit sets (OMNI, SUN, AREA,
# SKY / OMNI, SUN)
_LIGHT_INTENSITY = {0, 1, 2, 3}
_LIGHT_COLOUR = {0, 1}


def edit_targets(materials, lights) -> dict:
    """Per edit kind, the ids that take it: materials without an opacity
    map, lights by type."""
    mats = [(i, int(m.mtype)) for i, m in enumerate(materials)
            if i > 0 and m.opacity == 0]
    return {
        "mat_colour": [i for i, t in mats if t in _HAS_DIFFUSE],
        "mat_roughness": [i for i, t in mats if t in _HAS_ROUGHNESS],
        "light_intensity": [i for i, l in enumerate(lights)
                            if int(l.ltype) in _LIGHT_INTENSITY],
        "light_colour": [i for i, l in enumerate(lights)
                         if int(l.ltype) in _LIGHT_COLOUR],
    }


def _edit(kind, rng, targets, materials, lights):
    ids = targets[kind]
    i = int(ids[rng.integers(len(ids))])
    if kind == "mat_colour":
        return ("mat", i, "diffuse_mul",
                tuple(int(v) for v in rng.integers(60, 256, size=3)))
    if kind == "mat_roughness":
        return ("mat", i, "roughness_mul",
                float(np.float32(rng.uniform(0.05, 0.8))))
    if kind == "light_intensity":
        base = float(lights[i].intensity)
        return ("light", i, "intensity",
                float(np.float32(base * rng.uniform(0.6, 1.4))))
    return ("light", i, "color",
            tuple(float(np.float32(v)) for v in rng.uniform(0.5, 1.0, size=3)))


def session(params: dict, seed: int, materials, lights):
    """The session's frames, warm-up first, as an endless generator."""
    rng = np.random.default_rng([int(seed), 0x5E55])
    targets = edit_targets(materials, lights)
    kinds = [k for k in ("mat_colour", "mat_roughness", "light_intensity",
                         "light_colour") if targets[k]]
    strafe, look = float(params["strafe_m"]), float(params["look_rad"])
    every = int(params["edit_every"])
    sign = 1.0
    n = 0
    k_edit = 0

    def frame(kind, edit=None):
        if kind == "drag":
            return {"strafe": sign * strafe, "look": (sign * look, 0.0),
                    "edit": edit}
        return {"strafe": 0.0, "look": None, "edit": edit}

    for entry in params["warmup"]:
        if entry == "edit":
            yield frame("still", _edit(kinds[0], rng, targets, materials,
                                       lights))
        else:
            yield frame(entry)
    lengths = [int(x) for x in params["segment_frames"]]
    while True:
        drags = list(rng.permutation(lengths))
        stills = list(rng.permutation(lengths))
        for d_len, s_len in zip(drags, stills):
            for kind, length in (("drag", d_len), ("still", s_len)):
                for _ in range(int(length)):
                    n += 1
                    edit = None
                    if n % every == 0:
                        edit = _edit(kinds[k_edit % len(kinds)], rng,
                                     targets, materials, lights)
                        k_edit += 1
                    yield frame(kind, edit)
            sign = -sign


def start_frames(params: dict, seed: int, materials, lights) -> int:
    """Frames from the session's start through its first run of still
    frames after the warm-up: the check's start stage ends there, where
    the accumulation has gathered the most launches since a restart."""
    frames = session(params, seed, materials, lights)
    n_warm = len(params["warmup"])
    still_seen = False
    for i, fr in enumerate(frames):
        still = not fr["strafe"] and fr["look"] is None
        if i >= n_warm and still:
            still_seen = True
        elif still_seen:
            return i
    raise AssertionError("a session never ends")


def apply_edit(edit, materials, lights, spectrum_cls):
    """``(materials, lights)`` with ``edit`` applied to copies;
    ``spectrum_cls`` is the side's Spectrum (a light's colour)."""
    what, i, field, value = edit
    materials, lights = list(materials), list(lights)
    if what == "mat":
        m = copy.copy(materials[i])
        setattr(m, field, value)
        materials[i] = m
    else:
        lt = copy.copy(lights[i])
        if field == "color":
            lt.color = spectrum_cls.from_rgb(np.asarray(value, np.float32),
                                             True)
        else:
            setattr(lt, field, value)
        lights[i] = lt
    return materials, lights


def move_camera(camera, frame):
    """Applies a frame's drag to ``camera`` (a side's Camera) in place, as
    the viewer's strafe and look-around do; True when it moved."""
    moved = False
    if frame["strafe"]:
        camera.strafe(frame["strafe"])
        moved = True
    if frame["look"] is not None:
        camera.look_around(*frame["look"])
        moved = True
    return moved
