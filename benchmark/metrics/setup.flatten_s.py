"""Seconds in the program's flatten_scene_np during set-up (host flatten,
opacity split, BVH build or cache load)."""


def read(run):
    return run.spans.get("setup.flatten_s")
