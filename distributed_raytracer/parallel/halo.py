"""Geometry-sharded rendering with ray halo exchange.

The second sharded-geometry schedule (BASELINE config 5: "block-partitioned
across N >= 2 hosts with secondary-ray halo exchange"). Where parallel/ring.py
rotates *triangle blocks* past resident rays (N ppermute steps of the full
geometry shard), this module keeps geometry pinned and routes *rays* to the
shards that own the geometry they might hit — the reference's "every worker
holds the whole scene" (registrar.go:41-47) relaxed into spatially partitioned
geometry plus boundary-ray exchange.

Comm cost per frame: one `all_gather` of the ray set (queries out) plus one
`all_to_all` of per-shard hit candidates (results home) per pass — O(rays),
independent of triangle count. The ring's cost is O(triangles) per frame.
For the config-5 regime (multi-million tris, fixed resolution) rays are
orders of magnitude smaller than geometry, so the halo schedule is the one
that scales; the ring remains preferable when rays >> triangles.

Exactness: triangles live entirely inside their shard's AABB, so a ray's
nearest hit is the min over shards of per-shard nearest hits — an associative
fold, like the ring's online reduction. Per-shard candidates are folded with
(t, then global triangle id) lexicographic order, reproducing the replicated
renderer's global argmin tie-break exactly.

Routing mask: each shard computes a conservative segment-vs-shard-AABB slab
test for every received ray and zeroes non-crossing rays' work. Under dense
XLA this gates no FLOPs (documented divergence: it is the work-list seed for
a future Pallas compaction), but it is also how a bucketed implementation
would bound halo traffic: the mask's psum is reported as `halo_density` by
the diagnostics handle.

Schedule per device (R_loc resident rays, T/N resident triangles):
  1. raygen for the resident band of the frame.
  2 (primary halo). all_gather rays -> intersect vs LOCAL shard only ->
     all_to_all candidates -> fold min at the ray's home device.
  3 (secondary halo). shadow segments from the folded hit points, per light:
     all_gather queries -> local any-hit (with per-ray t_max and self-exclude)
     -> all_to_all 0/1 -> OR at home.
  4. Phong shading from the carried payload, purely local.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

try:
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

from distributed_raytracer.models.camera import Camera, CameraArrays
from distributed_raytracer.models.scene import SceneArrays
from distributed_raytracer.ops import raygen
from distributed_raytracer.parallel.ring import (HitPayload, RingShard,
                                                     _local_any,
                                                     _local_nearest,
                                                     pad_for_ring)
from distributed_raytracer.utils.config import RenderConfig, DEFAULT_CONFIG

AXIS = "halo"


def shard_bounds(arrays: SceneArrays, n_shards: int) -> tuple:
    """(N, 3) lo / hi AABBs of each contiguous triangle shard (host-side).

    Call after Morton-ordering (models/bvh.morton_order) so contiguous
    shards are spatially compact — the whole point of routing by AABB."""
    p0 = np.asarray(arrays.p0, np.float64)
    p1 = p0 + np.asarray(arrays.e1, np.float64)
    p2 = p0 + np.asarray(arrays.e2, np.float64)
    lo = np.minimum(np.minimum(p0, p1), p2)
    hi = np.maximum(np.maximum(p0, p1), p2)
    # Degenerate all-zero padding triangles would drag every shard AABB to
    # the origin; give them inverted bounds instead.
    degenerate = (np.asarray(arrays.geo_n) == 0).all(axis=1)
    lo[degenerate] = np.inf
    hi[degenerate] = -np.inf
    t = lo.shape[0]
    assert t % n_shards == 0, "pad_for_ring first"
    lo = lo.reshape(n_shards, t // n_shards, 3).min(axis=1)
    hi = hi.reshape(n_shards, t // n_shards, 3).max(axis=1)
    return (np.nan_to_num(lo, posinf=1.0).astype(np.float32),
            np.nan_to_num(hi, neginf=-1.0).astype(np.float32))


def _segment_mask(origins, dirs, t_max, lo, hi):
    """(R,) bool slab test: does segment o + s*d, s in [0, t_max], cross the
    AABB [lo, hi]? origins (R,3) or (3,), dirs (R,3). Exact for rays (the
    routing test of the halo schedule, shared/geom/box.go:29's role)."""
    o = origins[None, :] if origins.ndim == 1 else origins
    inv = 1.0 / jnp.where(dirs == 0.0, jnp.inf, dirs)
    a = (lo[None, :] - o) * inv
    b = (hi[None, :] - o) * inv
    # Zero-direction axes: inside the slab iff lo <= o <= hi.
    inside = (o >= lo[None, :]) & (o <= hi[None, :])
    t1 = jnp.where(dirs == 0.0, jnp.where(inside, -jnp.inf, jnp.inf),
                   jnp.minimum(a, b))
    t2 = jnp.where(dirs == 0.0, jnp.where(inside, jnp.inf, -jnp.inf),
                   jnp.maximum(a, b))
    enter = jnp.maximum(t1.max(axis=1), 0.0)
    exit_ = jnp.minimum(t2.min(axis=1), t_max)
    return enter <= exit_


def _fold_payloads(parts: HitPayload, n: int) -> HitPayload:
    """Fold (N, R_loc) per-shard candidates into the home payload with the
    global argmin tie-break (min t, then min global triangle id)."""
    pieces = [jax.tree.map(lambda a: a[i], parts) for i in range(n)]

    def fold2(a: HitPayload, b: HitPayload) -> HitPayload:
        better = (b.t < a.t) | ((b.t == a.t) & (b.tri < a.tri))

        def sel(x, y):
            m = better[:, None] if y.ndim > 1 else better
            return jnp.where(m, x, y)

        return jax.tree.map(sel, b, a)

    return functools.reduce(fold2, pieces)


def make_halo_renderer(arrays: SceneArrays, width: int, height: int,
                       mesh: Optional[Mesh] = None,
                       cfg: RenderConfig = DEFAULT_CONFIG):
    """Build a jitted halo-exchange renderer over `mesh`.

    `arrays` must be padded via pad_for_ring(mesh size); Morton-order the
    triangles first (Scene.bake_bvh does; for raw bake() use
    models/bvh.morton_order + reorder) or shard AABBs will all span the
    scene and the routing masks stay dense.

    Returns render(cam) -> (H, W, 3) numpy; `.device_fn` skips the host
    gather, `.halo_density(cam)` reports the mean fraction of shards each
    ray is routed to (1/N = perfect spatial separation, 1.0 = no benefit).
    """
    if mesh is None:
        mesh = jax.make_mesh((len(jax.devices()),), (AXIS,))
    n = int(mesh.devices.size)
    n_rays = width * height
    r_pad = -(-n_rays // n) * n
    r_loc = r_pad // n

    t_total = arrays.p0.shape[0]
    assert t_total % n == 0, "call pad_for_ring first"
    t_shard = t_total // n

    lo_np, hi_np = shard_bounds(arrays, n)
    lights_pos = jnp.asarray(arrays.light_pos)
    lights_col = jnp.asarray(arrays.light_col)
    n_lights = int(lights_pos.shape[0])

    def shard_fn(cam: CameraArrays, shard: RingShard, lo, hi):
        me = jax.lax.axis_index(AXIS)
        my_lo, my_hi = lo[me], hi[me]

        # 1. Resident rays: a contiguous band of the flat pixel index.
        idx = me * r_loc + jnp.arange(r_loc, dtype=jnp.int32)
        dirs = raygen.ray_directions_flat(cam, width, height, idx)

        # 2. Primary halo: queries out, candidates home.
        all_dirs = jax.lax.all_gather(dirs, AXIS, tiled=True)  # (r_pad, 3)
        init = HitPayload(
            t=jnp.full((r_pad,), jnp.inf, jnp.float32),
            tri=jnp.full((r_pad,), 2 ** 30, jnp.int32),
            u=jnp.zeros((r_pad,), jnp.float32),
            v=jnp.zeros((r_pad,), jnp.float32),
            n0=jnp.zeros((r_pad, 3), jnp.float32),
            n1=jnp.zeros((r_pad, 3), jnp.float32),
            n2=jnp.zeros((r_pad, 3), jnp.float32),
            geo_n=jnp.zeros((r_pad, 3), jnp.float32),
            mat=jnp.zeros((r_pad,), jnp.int32),
        )
        cand = _local_nearest(shard, cam.pos, all_dirs, init)
        # Routing mask: rays that provably miss this shard's AABB carry no
        # candidate (identity of the fold). Conservative-exact, so this only
        # reaffirms what _local_nearest found — it exists to seed a bucketed
        # Pallas variant and the halo_density diagnostic.
        route = _segment_mask(cam.pos, all_dirs,
                              jnp.full((r_pad,), jnp.inf), my_lo, my_hi)
        cand = cand._replace(t=jnp.where(route, cand.t, jnp.inf))
        homed = jax.tree.map(
            lambda a: jax.lax.all_to_all(a, AXIS, split_axis=0,
                                         concat_axis=0, tiled=True), cand)
        payload = _fold_payloads(
            jax.tree.map(lambda a: a.reshape((n, r_loc) + a.shape[1:]), homed),
            n)

        # 3. Hit points + shading frames (local, resident rays only).
        valid = jnp.isfinite(payload.t)
        t_safe = jnp.where(valid, payload.t, 0.0)
        x = cam.pos[None, :] + t_safe[:, None] * dirs
        r1 = 1.0 - payload.u - payload.v
        nrm = (r1[:, None] * payload.n0 + payload.u[:, None] * payload.n1
               + payload.v[:, None] * payload.n2)
        nlen = jnp.linalg.norm(nrm, axis=-1, keepdims=True)
        normal = nrm / jnp.where(nlen > 0, nlen, 1.0)
        glen = jnp.linalg.norm(payload.geo_n, axis=-1, keepdims=True)
        geo = payload.geo_n / jnp.where(glen > 0, glen, 1.0)

        # 4. Secondary halo: shadow segments out, occlusion bits home.
        shadowed = []
        for li in range(n_lights):
            to_l = lights_pos[li][None, :] - x
            ldist = jnp.linalg.norm(to_l, axis=-1)
            ldir = to_l / ldist[:, None]
            side = jnp.where(jnp.sum(geo * ldir, axis=-1) >= 0.0,
                             1.0, -1.0)
            so = (x + cfg.shadow_offset * ldir
                  + (cfg.shadow_normal_offset * side)[:, None] * geo)
            # Dead rays (primary miss) carry a zero-length segment.
            st = jnp.where(valid, ldist - cfg.shadow_offset, 0.0)
            g_o = jax.lax.all_gather(so, AXIS, tiled=True)
            g_d = jax.lax.all_gather(ldir, AXIS, tiled=True)
            g_t = jax.lax.all_gather(st, AXIS, tiled=True)
            g_x = jax.lax.all_gather(payload.tri, AXIS, tiled=True)
            hit = _local_any(shard, g_o, g_d, g_t, g_x)
            hit &= _segment_mask(g_o, g_d, g_t, my_lo, my_hi)
            homed_bits = jax.lax.all_to_all(hit.astype(jnp.int32), AXIS,
                                            split_axis=0, concat_axis=0,
                                            tiled=True)
            shadowed.append(homed_bits.reshape(n, r_loc).max(axis=0) > 0)

        # 5. Phong (identical math to the ring's shade step).
        mat = payload.mat
        ka = jnp.asarray(arrays.mat_ka)[mat]
        kd = jnp.asarray(arrays.mat_kd)[mat]
        ks = jnp.asarray(arrays.mat_ks)[mat]
        ns = jnp.asarray(arrays.mat_ns)[mat]
        cam_dir = cam.pos[None, :] - x
        cdl = jnp.linalg.norm(cam_dir, axis=-1, keepdims=True)
        cam_dir = cam_dir / jnp.where(cdl > 0, cdl, 1.0)

        colour = ka
        for li in range(n_lights):
            to_l = lights_pos[li][None, :] - x
            ldist = jnp.linalg.norm(to_l, axis=-1, keepdims=True)
            ldir = to_l / jnp.where(ldist > 0, ldist, 1.0)
            l_dot_n = jnp.sum(ldir * normal, axis=-1)
            diff = jnp.maximum(l_dot_n, 0.0)
            refl = 2.0 * l_dot_n[:, None] * normal - ldir
            spec = jnp.power(jnp.maximum(
                jnp.sum(refl * cam_dir, axis=-1), 0.0), ns)
            contrib = (kd * diff[:, None]
                       + ks * spec[:, None]) * lights_col[li][None, :]
            colour = colour + jnp.where(shadowed[li][:, None], 0.0, contrib)
        colour = jnp.minimum(colour, 1.0)
        return jnp.where(valid[:, None], colour, 0.0)

    def density_fn(cam: CameraArrays, shard: RingShard, lo, hi):
        me = jax.lax.axis_index(AXIS)
        idx = me * r_loc + jnp.arange(r_loc, dtype=jnp.int32)
        dirs = raygen.ray_directions_flat(cam, width, height, idx)
        all_dirs = jax.lax.all_gather(dirs, AXIS, tiled=True)
        route = _segment_mask(cam.pos, all_dirs,
                              jnp.full((r_pad,), jnp.inf), lo[me], hi[me])
        return jax.lax.psum(route.mean(), AXIS)[None] / n

    tri_fields = RingShard._fields[:-1]
    shard_specs = RingShard(**{f: P(AXIS) for f in tri_fields}, base=P(AXIS))

    render_padded = jax.jit(shard_map(
        shard_fn, mesh=mesh, in_specs=(P(), shard_specs, P(), P()),
        out_specs=P(AXIS)))
    density_padded = jax.jit(shard_map(
        density_fn, mesh=mesh, in_specs=(P(), shard_specs, P(), P()),
        out_specs=P(AXIS)))

    bases = jnp.arange(n, dtype=jnp.int32) * t_shard
    shard_value = RingShard(
        p0=jnp.asarray(arrays.p0), e1=jnp.asarray(arrays.e1),
        e2=jnp.asarray(arrays.e2), geo_n=jnp.asarray(arrays.geo_n),
        plane_d=jnp.asarray(arrays.plane_d), k_u=jnp.asarray(arrays.k_u),
        k_v=jnp.asarray(arrays.k_v), c_u=jnp.asarray(arrays.c_u),
        c_v=jnp.asarray(arrays.c_v), n0=jnp.asarray(arrays.n0),
        n1=jnp.asarray(arrays.n1), n2=jnp.asarray(arrays.n2),
        mat_id=jnp.asarray(arrays.mat_id), base=bases,
    )
    lo_j, hi_j = jnp.asarray(lo_np), jnp.asarray(hi_np)

    def render(cam) -> np.ndarray:
        cam_arrays = cam.to_arrays() if isinstance(cam, Camera) else cam
        flat = np.asarray(render_padded(cam_arrays, shard_value, lo_j, hi_j))
        return flat[:n_rays].reshape(height, width, 3)

    render.device_fn = lambda c: render_padded(c, shard_value, lo_j, hi_j)
    render.halo_density = lambda cam: float(np.asarray(density_padded(
        cam.to_arrays() if isinstance(cam, Camera) else cam,
        shard_value, lo_j, hi_j))[0])
    return render
