"""Per-frame scene mutability: object translations + lights as device diffs.

The reference ships a mutable-state diff in every work order — object
positions, lights, camera (shared/state/environment.go:65-69) — and every
worker re-links it and REBUILDS its object R-tree per frame
(worker/distributed/main.go:56-64, environment.go:73-98). Round 1 only made
the camera a per-frame input; moving an object needed a full host re-bake
(seconds). This module makes the whole diff a per-frame device argument:

  - Translation-only placement (object.go:17-22) means a shift d touches
    exactly: p0' = p0 + d, plane_d' = plane_d + geo_n.d, c_u' = c_u - d.k_u,
    c_v' = c_v - d.k_v; edges, normals, and the barycentric projectors are
    translation-invariant. One fused elementwise pass over the packed
    triangle rows per frame — no re-bake, no BVH rebuild.
  - The BVH survives because bake_bvh_grouped Morton-orders each object
    separately: a leaf block belongs to exactly one object, so its AABB
    shifts exactly by that object's delta.
  - Lights are folded per frame: the per-light origin-folded rows the
    shadow traversal consumes (bsr_trace.lights_origin_packs) are static at
    construction in CulledRenderer; here they are recomputed from the
    diffed rows inside the same jit (a small dense op over (L*T, 16)).

Everything reuses CulledRenderer's fused pipeline unchanged — its stages
already take every array as a jit argument, so the diff transform composes
in front of _full_fn with zero changes to the hot kernels.
"""

from __future__ import annotations

import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np

_log = logging.getLogger(__name__)

from distributed_raytracer.models.camera import Camera
from distributed_raytracer.models.scene import Scene, SceneDiff
from distributed_raytracer.ops import shade
from distributed_raytracer.ops.pallas import bsr_trace
from distributed_raytracer.ops.render_bvh import CulledRenderer, _bucket


class DynamicCulledRenderer(CulledRenderer):
    """CulledRenderer whose render step takes a SceneDiff each frame."""

    def __init__(self, scene: Scene, width: int, height: int, **kwargs):
        self._scene_ref = scene
        super().__init__(scene, width, height, **kwargs)
        self._dyn_cache = {}

    # CulledRenderer.__init__ calls scene.bake_bvh; intercept the bake to
    # use the per-object grouping and stash the ownership maps.
    # (The parent calls this exact method — see the override hook there.)
    def _bake_scene(self, scene: Scene, block_size: int):
        arrays, tree, obj_id, block_obj, obj_pos0 = scene.bake_bvh_grouped(
            block_size=block_size)
        self._obj_id = jax.device_put(jnp.asarray(obj_id))
        self._block_obj = jax.device_put(jnp.asarray(block_obj))
        self.obj_pos0 = jax.device_put(jnp.asarray(obj_pos0))
        return arrays, tree

    def _apply_diff(self, scene, tris16, table32, blo, bhi, diff: SceneDiff):
        """Fold the diff into the packed arrays (device, under jit)."""
        delta = diff.obj_pos - self.obj_pos0                 # (O, 3)
        dt = delta[self._obj_id]                             # (T, 3)
        geo_n, ku, kv = tris16[:, 0:3], tris16[:, 4:7], tris16[:, 8:11]
        plane = tris16[:, 3:4] + jnp.sum(geo_n * dt, 1, keepdims=True)
        cu = tris16[:, 7:8] - jnp.sum(ku * dt, 1, keepdims=True)
        cv = tris16[:, 11:12] - jnp.sum(kv * dt, 1, keepdims=True)
        pad = tris16[:, 12:]
        tris16_d = jnp.concatenate([geo_n, plane, ku, cu, kv, cv, pad], 1)

        table32_d = table32.at[0:3, :].add(dt.T)   # p0 rows ((32, T) layout)
        blo_d = blo + delta[self._block_obj]                 # exact shift
        bhi_d = bhi + delta[self._block_obj]
        # The pipeline reads only lights (and array shapes) from the
        # SceneArrays pytree; the per-triangle fields it consumes are the
        # packed rows above, so those stay as baked.
        scene_d = scene._replace(light_pos=diff.light_pos,
                                 light_col=diff.light_col)
        lights_scal_d = bsr_trace.lights_origin_packs(tris16_d,
                                                      diff.light_pos)
        return scene_d, tris16_d, lights_scal_d, table32_d, blo_d, bhi_d

    def _dyn_fn(self, pads, scene, tris16, table32, blo, bhi, perm, cam,
                diff):
        # The superblock unions recompute from the shifted block AABBs
        # inside the cull, so the hierarchy stays exact.
        (scene_d, tris16_d, lights_scal_d, table32_d, blo_d,
         bhi_d) = self._apply_diff(scene, tris16, table32, blo, bhi, diff)
        return self._full_fn(pads, scene_d, tris16_d, lights_scal_d,
                             table32_d, blo_d, bhi_d, perm, cam)

    def render_dynamic(self, camera, diff: SceneDiff, verify: bool = False):
        """One fused dispatch: diff fold + cull + BSR + shadows + shading.

        Buckets come from the parent's freeze state (size with a
        representative camera first, or let the first call run the static
        sizing render); verify=True re-sizes on overflow as usual.
        """
        cam = camera.to_arrays() if isinstance(camera, Camera) else camera
        if self._fused is None:
            self.freeze(camera)
        pads = self._frozen_pads
        diff = SceneDiff(*(jnp.asarray(a, jnp.float32) for a in diff))

        def dispatch(pads):
            fn = self._dyn_cache.get(pads)
            if fn is None:
                fn = jax.jit(functools.partial(self._dyn_fn, pads))
                self._dyn_cache[pads] = fn
            return fn(self.arrays, self.tris_packed, self.shade_tbl,
                      self.block_lo, self.block_hi,
                      self._perm, cam, diff)

        img, counts = dispatch(pads)
        if verify:
            # Loop until every count fits its bucket: a truncated level-1
            # list makes the reported level-2 counts undercounts, so one
            # refreeze is not sufficient (render_fast's verify loop).
            fits = False
            for _ in range(8):
                got = tuple(int(c) for c in np.asarray(counts))
                if all(g <= p for g, p in zip(got, self._frozen_pads)):
                    fits = True
                    break
                self._last_counts = got
                self.freeze(camera)   # grow-only
                img, counts = dispatch(self._frozen_pads)
            if not fits:
                _log.warning(
                    "render_dynamic verify did not converge in 8 rounds "
                    "(counts %s vs pads %s); image may drop blocks",
                    tuple(int(c) for c in np.asarray(counts)),
                    self._frozen_pads)
        return img
