"""Geometry-sharded ring rendering (the ring-attention schedule for rays).

For scenes too large to replicate per device (BASELINE config 5), geometry
is block-partitioned across the mesh and *rotated* past resident rays with
`jax.lax.ppermute` — the ray-tracing analog of ring attention (SURVEY.md §5
"Long-context"): rays are queries, triangle blocks are keys, and the online
reduction is nearest-hit min (associative, so blockwise streaming is exact,
like the online softmax but simpler).

Schedule per device (R/N resident rays, T/N resident triangles):
  phase 1 — N ring steps: intersect rays x local block, fold the per-ray
    minimum *and its shading payload* (normal-interpolation inputs, material
    id, barycentrics) into a carry, then rotate the block to the right
    neighbor. Carrying the payload avoids any cross-device gather of the
    winning triangle's data afterwards.
  phase 2 — shadow queries from the final hit points; N more ring steps of
    any-hit OR-accumulation per light.
  shade — pure local math from the carried payload + replicated
    materials/lights.

Compute/communication overlap: each step's ppermute is issued on data not
needed until the next step, so XLA can overlap transfer with intersection.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

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
from distributed_raytracer.ops import intersect, raygen
from distributed_raytracer.utils.config import RenderConfig, DEFAULT_CONFIG

AXIS = "ring"


def _vary(x):
    """Mark x as varying over the ring axis (scan carries must match the
    per-device-updated values' types). pcast replaces the deprecated pvary."""
    if hasattr(jax.lax, "pcast"):
        return jax.lax.pcast(x, AXIS, to="varying")
    return jax.lax.pvary(x, (AXIS,))


class RingShard(NamedTuple):
    """The rotating geometry payload: one shard of per-triangle data."""

    p0: jnp.ndarray; e1: jnp.ndarray; e2: jnp.ndarray
    geo_n: jnp.ndarray; plane_d: jnp.ndarray
    k_u: jnp.ndarray; k_v: jnp.ndarray; c_u: jnp.ndarray; c_v: jnp.ndarray
    n0: jnp.ndarray; n1: jnp.ndarray; n2: jnp.ndarray
    mat_id: jnp.ndarray
    base: jnp.ndarray   # () int32: global index of this shard's first triangle


class HitPayload(NamedTuple):
    """Per-ray carried best-hit state (no gathers needed afterwards)."""

    t: jnp.ndarray        # (R,)
    tri: jnp.ndarray      # (R,) global triangle id
    u: jnp.ndarray        # (R,)
    v: jnp.ndarray
    n0: jnp.ndarray       # (R, 3) winning triangle's vertex normals
    n1: jnp.ndarray
    n2: jnp.ndarray
    geo_n: jnp.ndarray    # (R, 3)
    mat: jnp.ndarray      # (R,) int32


def pad_for_ring(arrays: SceneArrays, n_shards: int) -> SceneArrays:
    """Pad the triangle axis so it divides evenly across shards."""
    t = arrays.p0.shape[0]
    t_new = -(-t // n_shards) * n_shards
    if t_new == t:
        return arrays
    pad = t_new - t
    per_tri = {"p0", "e1", "e2", "geo_n", "plane_d", "k_u", "k_v",
               "c_u", "c_v", "n0", "n1", "n2", "mat_id"}
    rep = {}
    for name in per_tri:
        a = np.asarray(getattr(arrays, name))
        width = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
        rep[name] = np.pad(a, width)
    return arrays._replace(**rep)


def _local_nearest(shard: RingShard, origins, dirs, payload: HitPayload,
                   eps: float = intersect.BARY_EPS) -> HitPayload:
    """Fold the local block's nearest hits into the carried payload."""
    n_t = shard.geo_n.T
    mm = lambda a, b: jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)
    den = mm(dirs, n_t)
    d_ku = mm(dirs, shard.k_u.T)
    d_kv = mm(dirs, shard.k_v.T)
    if origins.ndim == 1:
        o_n = mm(origins, n_t)[None, :]
        o_ku = mm(origins, shard.k_u.T)[None, :]
        o_kv = mm(origins, shard.k_v.T)[None, :]
    else:
        o_n = mm(origins, n_t)
        o_ku = mm(origins, shard.k_u.T)
        o_kv = mm(origins, shard.k_v.T)
    t = (shard.plane_d[None, :] - o_n) / den
    u = (o_ku + shard.c_u[None, :]) + t * d_ku
    v = (o_kv + shard.c_v[None, :]) + t * d_kv
    valid = ((den != 0.0) & (t >= 0.0)
             & (u >= -eps) & (u <= 1.0 + eps)
             & (u + v >= -eps) & (u + v <= 1.0 + eps)
             & (v >= -eps))
    cand = jnp.where(valid, t, jnp.inf)
    loc = jnp.argmin(cand, axis=1).astype(jnp.int32)
    tmin = jnp.take_along_axis(cand, loc[:, None], axis=1)[:, 0]

    better = tmin < payload.t
    sel = lambda new, old: jnp.where(better[..., None] if old.ndim > 1
                                     else better, new, old)
    take = lambda a: a[loc]
    rows = jnp.arange(dirs.shape[0])
    return HitPayload(
        t=jnp.where(better, tmin, payload.t),
        tri=jnp.where(better, shard.base + loc, payload.tri),
        u=jnp.where(better, u[rows, loc], payload.u),
        v=jnp.where(better, v[rows, loc], payload.v),
        n0=sel(take(shard.n0), payload.n0),
        n1=sel(take(shard.n1), payload.n1),
        n2=sel(take(shard.n2), payload.n2),
        geo_n=sel(take(shard.geo_n), payload.geo_n),
        mat=jnp.where(better, take(shard.mat_id), payload.mat),
    )


def _local_any(shard: RingShard, origins, dirs, t_max, exclude,
               eps: float = intersect.BARY_EPS) -> jnp.ndarray:
    mm = lambda a, b: jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)
    den = mm(dirs, shard.geo_n.T)
    d_ku = mm(dirs, shard.k_u.T)
    d_kv = mm(dirs, shard.k_v.T)
    o_n = mm(origins, shard.geo_n.T)
    o_ku = mm(origins, shard.k_u.T)
    o_kv = mm(origins, shard.k_v.T)
    t = (shard.plane_d[None, :] - o_n) / den
    u = (o_ku + shard.c_u[None, :]) + t * d_ku
    v = (o_kv + shard.c_v[None, :]) + t * d_kv
    gids = shard.base + jnp.arange(shard.p0.shape[0], dtype=jnp.int32)
    valid = ((den != 0.0) & (t >= 0.0)
             & (u >= -eps) & (u <= 1.0 + eps)
             & (u + v >= -eps) & (u + v <= 1.0 + eps)
             & (v >= -eps)
             & (gids[None, :] != exclude[:, None]))
    return jnp.any(valid & (t <= t_max[:, None]), axis=1)


def _rotate(shard: RingShard, n: int) -> RingShard:
    perm = [(i, (i + 1) % n) for i in range(n)]
    return jax.tree.map(lambda a: jax.lax.ppermute(a, AXIS, perm), shard)


def _hit_frames(payload: HitPayload, origins, dirs):
    """(valid, x, normal, geo) from a folded payload."""
    valid = jnp.isfinite(payload.t)
    t_safe = jnp.where(valid, payload.t, 0.0)
    x = origins[None, :] + t_safe[:, None] * dirs
    r1 = 1.0 - payload.u - payload.v
    nrm = (r1[:, None] * payload.n0 + payload.u[:, None] * payload.n1
           + payload.v[:, None] * payload.n2)
    nlen = jnp.linalg.norm(nrm, axis=-1, keepdims=True)
    normal = nrm / jnp.where(nlen > 0, nlen, 1.0)
    glen = jnp.linalg.norm(payload.geo_n, axis=-1, keepdims=True)
    geo = payload.geo_n / jnp.where(glen > 0, glen, 1.0)
    return valid, x, normal, geo


def _shadow_inputs(lights_pos, cfg, x, geo, valid):
    """Per-light shadow segments (origin, dir, t_max) — tracer.go:64
    semantics with the f32 normal lift."""
    sh_origin, sh_dir, sh_tmax = [], [], []
    for li in range(lights_pos.shape[0]):
        to_l = lights_pos[li][None, :] - x
        ldist = jnp.linalg.norm(to_l, axis=-1)
        ldir = to_l / ldist[:, None]
        side = jnp.where(jnp.sum(geo * ldir, axis=-1) >= 0.0, 1.0, -1.0)
        sh_origin.append(x + cfg.shadow_offset * ldir
                         + (cfg.shadow_normal_offset * side)[:, None] * geo)
        sh_dir.append(ldir)
        sh_tmax.append(jnp.where(valid, ldist - cfg.shadow_offset, 0.0))
    return sh_origin, sh_dir, sh_tmax


def _phong(arrays: SceneArrays, lights_col, origins, x, normal, payload,
           sh_dir, shadowed, valid):
    """Phong accumulation from the carried payload (materials replicated)."""
    mat = payload.mat
    ka = jnp.asarray(arrays.mat_ka)[mat]
    kd = jnp.asarray(arrays.mat_kd)[mat]
    ks = jnp.asarray(arrays.mat_ks)[mat]
    ns = jnp.asarray(arrays.mat_ns)[mat]
    cam_dir = (origins[None, :] - x)
    cdl = jnp.linalg.norm(cam_dir, axis=-1, keepdims=True)
    cam_dir = cam_dir / jnp.where(cdl > 0, cdl, 1.0)

    colour = ka
    for li in range(len(sh_dir)):
        ldir = sh_dir[li]
        l_dot_n = jnp.sum(ldir * normal, axis=-1)
        diff = jnp.maximum(l_dot_n, 0.0)
        refl = 2.0 * l_dot_n[:, None] * normal - ldir
        spec = jnp.power(jnp.maximum(
            jnp.sum(refl * cam_dir, axis=-1), 0.0), ns)
        contrib = (kd * diff[:, None] + ks * spec[:, None]) * lights_col[li][None, :]
        lit = jnp.logical_not(shadowed[li])
        colour = colour + jnp.where(lit[:, None], contrib, 0.0)
    colour = jnp.minimum(colour, 1.0)
    return jnp.where(valid[:, None], colour, 0.0)


def make_ring_renderer(arrays: SceneArrays, width: int, height: int,
                       mesh: Optional[Mesh] = None,
                       cfg: RenderConfig = DEFAULT_CONFIG):
    """Build a jitted (sharded_scene, cam) -> flat colours renderer.

    `arrays` must already be padded via pad_for_ring(mesh size). Returns
    (render_fn, sharded_scene) where sharded_scene holds per-triangle fields
    sharded over the ring axis and small fields replicated.
    """
    if mesh is None:
        mesh = jax.make_mesh((len(jax.devices()),), (AXIS,))
    n = mesh.devices.size
    n_rays = width * height
    r_pad = -(-n_rays // n) * n

    t_total = arrays.p0.shape[0]
    assert t_total % n == 0, "call pad_for_ring first"
    t_shard = t_total // n

    lights_pos = jnp.asarray(arrays.light_pos)
    lights_col = jnp.asarray(arrays.light_col)
    n_lights = int(lights_pos.shape[0])

    def shard_fn(cam: CameraArrays, shard: RingShard):
        me = jax.lax.axis_index(AXIS)
        r_loc = r_pad // n
        idx = me * r_loc + jnp.arange(r_loc, dtype=jnp.int32)
        dirs = raygen.ray_directions_flat(cam, width, height, idx)
        origins = cam.pos

        init = HitPayload(
            t=jnp.full((r_loc,), jnp.inf, jnp.float32),
            tri=jnp.full((r_loc,), -1, jnp.int32),
            u=jnp.zeros((r_loc,), jnp.float32),
            v=jnp.zeros((r_loc,), jnp.float32),
            n0=jnp.zeros((r_loc, 3), jnp.float32),
            n1=jnp.zeros((r_loc, 3), jnp.float32),
            n2=jnp.zeros((r_loc, 3), jnp.float32),
            geo_n=jnp.zeros((r_loc, 3), jnp.float32),
            mat=jnp.zeros((r_loc,), jnp.int32),
        )

        # Mark the carries as varying over the ring axis (their updates
        # depend on per-device data, and scan requires matching types).
        init = jax.tree.map(_vary, init)

        # Phase 1: rotate geometry N times, folding nearest hits.
        def step1(carry, _):
            payload, sh = carry
            payload = _local_nearest(sh, origins, dirs, payload)
            sh = _rotate(sh, n)
            return (payload, sh), None

        (payload, shard_back), _ = jax.lax.scan(step1, (init, shard), None, length=n)

        valid, x, normal, geo = _hit_frames(payload, origins, dirs)

        # Phase 2: shadow ring per light (fused into one rotation by
        # carrying an (L, R) shadowed accumulator).
        sh_origin, sh_dir, sh_tmax = _shadow_inputs(lights_pos, cfg, x, geo,
                                                    valid)

        def step2(carry, _):
            shadowed, sh = carry
            new = [jnp.logical_or(shadowed[li], _local_any(
                sh, sh_origin[li], sh_dir[li], sh_tmax[li], payload.tri))
                for li in range(n_lights)]
            sh = _rotate(sh, n)
            return (jnp.stack(new) if n_lights else shadowed, sh), None

        shadowed0 = _vary(jnp.zeros((n_lights, r_loc), bool))
        (shadowed, _), _ = jax.lax.scan(step2, (shadowed0, shard_back), None, length=n)

        return _phong(arrays, lights_col, origins, x, normal, payload,
                      sh_dir, shadowed, valid)

    tri_fields = RingShard._fields[:-1]  # all but base are arrays over tris
    shard_specs = RingShard(**{f: P(AXIS) for f in tri_fields}, base=P(AXIS))

    sharded = shard_map(shard_fn, mesh=mesh,
                        in_specs=(P(), shard_specs), out_specs=P(AXIS))
    render_padded = jax.jit(sharded)

    # Build the sharded geometry value.
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

    def render(cam) -> np.ndarray:
        cam_arrays = cam.to_arrays() if isinstance(cam, Camera) else cam
        flat = np.asarray(render_padded(cam_arrays, shard_value))
        return flat[:n_rays].reshape(height, width, 3)

    render.device_fn = lambda cam_arrays: render_padded(cam_arrays, shard_value)
    return render
