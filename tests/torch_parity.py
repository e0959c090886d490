"""Helpers for the tests that hold glaze_tpu_torch against glaze_tpu: the
same inputs go through both packages, crossing as NumPy arrays."""

from __future__ import annotations

import numpy as np

_BVH_KEYS = ("nodes", "tri", "nodes16", "tri8", "n_nodes", "n_tris")
# the scene fields that hold a (single, unchunked) BVH
_TREE_FIELDS = ("bvh", "bvh_opaque", "bvh_alpha")


def jax_scene_to_numpy(scene) -> dict:
    """A glaze_tpu DeviceScene pulled to NumPy under the field names
    glaze_tpu_torch.scene.flatten.device_scene_from_numpy reads."""
    from glaze_tpu.scene.flatten import _SCENE_FIELDS

    out = {}
    for name in _TREE_FIELDS:
        tree = getattr(scene, name)
        if tree is None:
            continue
        for k in _BVH_KEYS:
            v = getattr(tree, k)
            out[f"{name}.{k}"] = v if isinstance(v, int) else np.asarray(v)
    for k in scene.atlas._fields:
        out[f"atlas.{k}"] = np.asarray(getattr(scene.atlas, k))
    for name in _SCENE_FIELDS:
        v = getattr(scene, name)
        if name in _TREE_FIELDS or name == "atlas" or v is None:
            continue
        out[name] = np.asarray(v)
    return out


def port_scene_from_jax(scene, device="cpu"):
    """The port's DeviceScene holding the same tables as a glaze_tpu one."""
    from glaze_tpu_torch.scene.flatten import device_scene_from_numpy

    return device_scene_from_numpy(jax_scene_to_numpy(scene), device)


def t2n(x):
    """torch tensor (or tuple of them) -> NumPy."""
    if isinstance(x, (tuple, list)):
        return tuple(t2n(v) for v in x)
    return x.detach().cpu().numpy()


def j2n(x):
    if isinstance(x, (tuple, list)):
        return tuple(j2n(v) for v in x)
    return np.asarray(x)


def golden_scenes_pair():
    """(glaze_tpu DeviceScene, camera) of the golden scene."""
    import golden_scenes as gs
    from glaze_tpu.scene.flatten import flatten_scene

    scene, camera, _ = flatten_scene(gs.MatRowScene())
    return scene, camera
