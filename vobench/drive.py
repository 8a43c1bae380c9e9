"""The drive a configuration names, rendered once and kept in
``vobench/cache/``: the frozen renderer (``reference/scene.py``) over a
spawn pool, the frames as 8-bit camera frames."""
from __future__ import annotations

import hashlib
import json
import multiprocessing
import os
from pathlib import Path

import numpy as np

from .reference import scene as scenemod

CACHE = Path(__file__).resolve().parent / "cache"


def make_scene(drive: dict) -> scenemod.TexturedScene:
    return scenemod.make_textured_scene(
        seed=drive["scene_seed"], num_frames=drive["frames"],
        image_shape=tuple(drive["image_shape"]), K=np.asarray(drive["K"]),
        step=drive["step_m"])


def _render(args):
    scene, i = args
    return scenemod.camera_frame(scene.render(i))


def frames(drive: dict, workers: int = 0):
    """(scene, (F, H, W) uint8 frames, seconds spent rendering)."""
    import time

    scene = make_scene(drive)
    key = hashlib.sha256((json.dumps(drive, sort_keys=True)
                          + Path(scenemod.__file__).read_text()).encode())
    path = CACHE / f"drive-{key.hexdigest()[:20]}.npy"
    if path.exists():
        return scene, np.load(path), 0.0
    t0 = time.perf_counter()
    items = [(scene, i) for i in range(scene.num_frames)]
    workers = min(len(items), workers or os.cpu_count() or 1)
    if workers <= 1:
        out = [_render(x) for x in items]
    else:
        with multiprocessing.get_context("spawn").Pool(workers) as pool:
            out = pool.map(_render, items)
    stack = np.stack(out)
    CACHE.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp.npy")
    np.save(tmp, stack)
    os.replace(tmp, path)
    return scene, stack, time.perf_counter() - t0
