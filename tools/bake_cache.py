"""Disk cache for expensive scene bakes (the multi-million-triangle configs).

Baking the 5.24M-triangle icosphere (BASELINE config 5) costs minutes of
host time (mesh synthesis, f64 intersection precompute, Morton sort, block
AABBs, packing) — far more than the bench budget. This caches the finished
(SceneArrays, BlockBVH, camera) bundle as an uncompressed .npz so bench runs
pay a ~2 GB mmap read instead.

Run directly to prebuild:  python tools/bake_cache.py
"""

from __future__ import annotations

import os
import time

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE_DIR = os.environ.get("DRT_SCENE_CACHE",
                           os.path.join(_REPO_ROOT, ".scene_cache"))
# Bump when bake_bvh/packing layout changes invalidate cached bundles.
VERSION = 1


def _path(name: str) -> str:
    return os.path.join(CACHE_DIR, f"{name}_v{VERSION}.npz")


def save_bundle(name: str, arrays, tree, camera) -> str:
    from distributed_raytracer.models.scene import SceneArrays

    os.makedirs(CACHE_DIR, exist_ok=True)
    path = _path(name)
    payload = {f"a_{f}": np.asarray(getattr(arrays, f))
               for f in SceneArrays._fields}
    np.savez(path, t_lo=tree.block_lo, t_hi=tree.block_hi,
             t_bs=np.int64(tree.block_size),
             cam_pos=np.asarray(camera.pos, np.float64),
             cam_fwd=np.asarray(camera.forward, np.float64),
             cam_fov=np.float64(camera.fov), **payload)
    return path


def load_bundle(name: str):
    """(SceneArrays, BlockBVH, Camera) or None if not cached."""
    from distributed_raytracer.models.bvh import BlockBVH
    from distributed_raytracer.models.camera import Camera
    from distributed_raytracer.models.scene import SceneArrays

    path = _path(name)
    if not os.path.exists(path):
        return None
    d = np.load(path)
    arrays = SceneArrays(**{f: d[f"a_{f}"] for f in SceneArrays._fields})
    tree = BlockBVH(block_lo=d["t_lo"], block_hi=d["t_hi"],
                    block_size=int(d["t_bs"]))
    cam = Camera.create(pos=d["cam_pos"], direction=d["cam_fwd"],
                        fov=float(d["cam_fov"]))
    return arrays, tree, cam


def load_icosphere(subdivisions: int, build_if_missing: bool = True):
    """An icosphere bundle by subdivision level (block 128): level 9 =
    5.24M tris (the BASELINE config-5 scene), level 8 = 1.31M tris."""
    name = f"icosphere{subdivisions}_bs128"
    got = load_bundle(name)
    if got is not None or not build_if_missing:
        return got
    from distributed_raytracer.utils import scenes as S

    t0 = time.time()
    scene = S.icosphere_scene(subdivisions)
    arrays, tree = scene.bake_bvh(block_size=128)
    save_bundle(name, arrays, tree, scene.camera)
    print(f"built + cached {name} bundle in {time.time() - t0:.0f}s")
    return arrays, tree, scene.camera


def load_icosphere9(build_if_missing: bool = True):
    """The BASELINE config-5 bundle (5.24M-tri icosphere, block 128)."""
    return load_icosphere(9, build_if_missing)


if __name__ == "__main__":
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    for sub in ([int(a) for a in sys.argv[1:]] or [9, 8]):
        arrays, tree, cam = load_icosphere(sub, build_if_missing=True)
        print(f"cached: {arrays.p0.shape[0]} tri slots, "
              f"{tree.num_blocks} blocks -> "
              f"{_path(f'icosphere{sub}_bs128')}")
