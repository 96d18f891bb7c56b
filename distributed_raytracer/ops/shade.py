"""Phong shading with hard shadows.

Reproduces worker/shared/tracer/tracer.go:53-77 `phong`:
  - colour starts at the material's ambient Ka (tracer.go:56)
  - per light: a shadow ray from the hit point, offset by 1e-4 along the
    light direction (tracer.go:64); the point is lit iff there is no blocker
    closer than the light (hits *beyond* the light do not shadow)
  - diffuse:  Kd * max(L.N, 0) * Lcol       (tracer.go:70)
  - specular: Ks * max(R.V, 0)^Ns * Lcol    (tracer.go:73), R the reflection
    of L about N, V toward the camera; Go's math.Pow(0,0)=1 convention applies
    (Ns=0 materials get full Ks when lit), matching jnp.power
  - all additions saturate at 1.0 per channel (colour.go:38-41). Because
    every contribution is non-negative, sequential saturating adds equal a
    single clamp of the sum — we accumulate then clamp once.
  - the normal is the smooth interpolated vertex normal, or the flat face
    normal for meshes without normals (object.go:91-96; the flat case is
    handled at bake time by writing the face normal into all vertex slots)

The module is split so the shadow *queries* (ray origins/dirs/tmax) are
separable from the shadow *answers*: the dense path answers them with
intersect.any_hit, the block-sparse path with the Pallas BSR any-hit kernel
(ops/render_bvh.py), both feeding the same accumulation in shade_core.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from distributed_raytracer.models.scene import SceneArrays
from distributed_raytracer.ops import intersect
from distributed_raytracer.utils.config import RenderConfig, DEFAULT_CONFIG


def _normalize(v, axis=-1):
    """Safe normalize: zero vectors (padding-triangle normals gathered for
    miss rays) stay zero instead of poisoning downstream math with NaNs —
    miss-ray values feed the shadow-query tile intervals before being
    discarded, so they must remain finite."""
    n = jnp.linalg.norm(v, axis=axis, keepdims=True)
    return v / jnp.where(n > 0.0, n, 1.0)


class ShadowQueries(NamedTuple):
    """Per-light shadow rays for a batch of C shaded points."""

    origin: jnp.ndarray   # (L, C, 3) offset shadow-ray origins
    ldir: jnp.ndarray     # (L, C, 3) unit directions toward each light
    t_max: jnp.ndarray    # (L, C) blocker range (light distance - offset)


class ShadePrep(NamedTuple):
    x: jnp.ndarray        # (C, 3) hit points
    normal: jnp.ndarray   # (C, 3) shading normals
    geo_n: jnp.ndarray    # (C, 3) unit geometric normals of the hit triangle
    ka: jnp.ndarray       # (C, 3) hit-material ambient
    kd: jnp.ndarray       # (C, 3) hit-material diffuse
    ks: jnp.ndarray       # (C, 3) hit-material specular
    ns: jnp.ndarray       # (C,) hit-material shininess
    queries: ShadowQueries


# Packed per-triangle shading table: every per-hit quantity the shader needs,
# gathered by winning triangle id in ONE (C, 32) gather instead of ~11
# separate (C, 3) gathers. Materials are folded per-triangle at pack time,
# collapsing the reference's face->material indirection (mesh.go:21-27).
_TBL = {"p0": 0, "k_u": 3, "k_v": 6, "n0": 9, "n1": 12, "n2": 15,
        "geo_n": 18, "ka": 21, "kd": 24, "ks": 27, "ns": 30}
TABLE_WIDTH = 32


@jax.jit
def table_rows_device(tris16, p0_t, n_t, mat_id, mat_ka, mat_kd, mat_ks,
                      mat_ns) -> jnp.ndarray:
    """pack_table().T assembled ON DEVICE — the multi-million-triangle
    transfer saver.

    Of the 32 table columns, 9 (k_u, k_v, geo_n) are bitwise copies or a
    pure function of the packed triangle columns the traversal already
    holds on device, and 10 (materials) gather from tiny per-material
    tables; so only p0 (3), the vertex normals (9, smooth meshes only —
    flat bakes have n == geo_n and pass n_t=None), and mat_id (1 int32)
    cross the host link: ~27% of the full (32, T) f32 table.

    tris16: (T, 16) bsr_trace.pack_tris columns (device); p0_t (3, T);
    n_t (9, T) stacked n0/n1/n2 rows or None; mat tables as in SceneArrays.
    Returns the (32, T) transposed table shade.prepare_packed consumes.
    """
    t = tris16.shape[0]
    geo = tris16[:, 0:3].T                       # (3, T) raw face normals
    glen = jnp.sqrt(jnp.sum(geo * geo, axis=0, keepdims=True))
    geo_unit = geo / jnp.where(glen > 0.0, glen, 1.0)
    ku = tris16[:, 4:7].T
    kv = tris16[:, 8:11].T
    if n_t is None:                              # flat bake: n == geo_n
        n_t = jnp.concatenate([geo, geo, geo], axis=0)
    mat = jnp.clip(mat_id, 0, mat_ka.shape[0] - 1)
    ka = mat_ka[mat].T
    kd = mat_kd[mat].T
    ks = mat_ks[mat].T
    ns = mat_ns[mat][None, :]
    zero = jnp.zeros((1, t), jnp.float32)
    return jnp.concatenate([p0_t, ku, kv, n_t, geo_unit, ka, kd, ks, ns,
                            zero], axis=0)


def pack_table(scene: SceneArrays, xp=jnp) -> jnp.ndarray:
    """(T, 32) float32 per-triangle shading rows (static per scene).

    Pass xp=numpy to build on the HOST: renderers pack once at construction
    and ship only the result — at multi-million-triangle scale, computing on
    device would first ship every raw per-triangle field to the device just
    to derive this one array."""
    geo = xp.asarray(scene.geo_n)
    glen = xp.linalg.norm(geo, axis=-1, keepdims=True)
    geo_unit = geo / xp.where(glen > 0.0, glen, 1.0)
    mat = xp.asarray(scene.mat_id)
    cols = [scene.p0, scene.k_u, scene.k_v, scene.n0, scene.n1, scene.n2,
            geo_unit, xp.asarray(scene.mat_ka)[mat],
            xp.asarray(scene.mat_kd)[mat], xp.asarray(scene.mat_ks)[mat],
            xp.asarray(scene.mat_ns)[mat][:, None],
            xp.zeros((scene.p0.shape[0], 1), xp.float32)]
    return xp.concatenate([xp.asarray(c, xp.float32) for c in cols], axis=1)


def prepare(scene: SceneArrays, origins: jnp.ndarray, dirs: jnp.ndarray,
            hits: intersect.Hits, cfg: RenderConfig = DEFAULT_CONFIG,
            table: jnp.ndarray | None = None) -> ShadePrep:
    """Hit points, normals, material rows, and shadow queries for every ray.

    `table` is the pack_table() array; pass it pre-built (and device-resident)
    from renderer setup — building it here is correct but re-concatenates per
    call under jit.
    """
    if table is None:
        table = pack_table(scene)
    t = jnp.where(hits.valid, hits.t, 0.0)  # keep hit-point math finite
    tri = jnp.maximum(hits.tri, 0)          # clamp miss sentinels for gathers
    g = table[tri]                          # (C, 32) the one gather
    col = lambda name, w=3: jax.lax.dynamic_slice_in_dim(
        g, _TBL[name], w, axis=1)

    if origins.ndim == 1:
        origins = origins[None, :]
    x = origins + t[:, None] * dirs
    # (x - p0) . k is better conditioned than x . k + c: the relative vector
    # is edge-scale, avoiding large-coordinate cancellation (see
    # intersect.barycentrics_at, which this inlines).
    rel = x - col("p0")
    u = jnp.sum(rel * col("k_u"), axis=-1)
    v = jnp.sum(rel * col("k_v"), axis=-1)
    r1 = 1.0 - u - v

    normal = _normalize(r1[:, None] * col("n0") + u[:, None] * col("n1")
                        + v[:, None] * col("n2"))

    # Shadow ray per light: origin offset 1e-4 along the light direction
    # (tracer.go:64) plus a float32-robustness lift along the geometric
    # normal, signed toward the light's side of the surface — clearance that
    # does not collapse at grazing light angles (RenderConfig
    # .shadow_normal_offset; the float64 reference needs no such term).
    geo = col("geo_n")

    def per_light(lpos):
        to_light = lpos[None, :] - x
        ldist = jnp.linalg.norm(to_light, axis=-1)
        ldir = to_light / ldist[:, None]
        side = jnp.where(jnp.sum(geo * ldir, axis=-1) >= 0.0, 1.0, -1.0)
        origin = (x + cfg.shadow_offset * ldir
                  + (cfg.shadow_normal_offset * side)[:, None] * geo)
        return origin, ldir, ldist - cfg.shadow_offset

    o, d, tm = jax.vmap(per_light)(scene.light_pos)
    return ShadePrep(x=x, normal=normal, geo_n=geo,
                     ka=col("ka"), kd=col("kd"), ks=col("ks"),
                     ns=col("ns", 1)[:, 0],
                     queries=ShadowQueries(origin=o, ldir=d, t_max=tm))


class PackedPrep(NamedTuple):
    """Row-layout ShadePrep for the block-sparse path: every per-ray vector
    is (3, C) rows (dense lanes), shadow queries are kernel-ready (L, 8, C)
    packed rays. Semantically identical to prepare(); layouts differ."""

    x: jnp.ndarray        # (3, C) hit points
    normal: jnp.ndarray   # (3, C) shading normals
    geo_n: jnp.ndarray    # (3, C) unit geometric normals
    ka: jnp.ndarray       # (3, C)
    kd: jnp.ndarray       # (3, C)
    ks: jnp.ndarray       # (3, C)
    ns: jnp.ndarray       # (C,)
    q: jnp.ndarray        # (L, 8, C) packed shadow rays (t_max in row 6)
    q_rev: jnp.ndarray    # (L, 8, C) REVERSED shadow rays: origin = the
    #   light, direction toward the (offset) surface point, t_max = the full
    #   segment length. Occlusion over [light, offset point] equals the
    #   forward query's [offset point, light] segment — same triangles, same
    #   epsilons at the surface end — but gives every ray of a light the
    #   SAME origin, enabling the shared-origin kernels (bsr_trace
    #   pack_tris_origin) and exact (point) origin interval hulls for the
    #   cull. Sole divergence: an occluder within shadow_offset (1e-4) of
    #   the light itself is seen by the reversed ray only.


def _normalize_rows(v):
    n = jnp.sqrt(jnp.sum(v * v, axis=0, keepdims=True))
    return v / jnp.where(n > 0.0, n, 1.0)


def prepare_packed(scene: SceneArrays, rays: jnp.ndarray,
                   hits: intersect.Hits, cfg: RenderConfig = DEFAULT_CONFIG,
                   table: jnp.ndarray | None = None) -> PackedPrep:
    """prepare() on packed (8, C) rays; see ShadePrep for the semantics.

    `table` is the TRANSPOSED (32, T) pack_table (renderers store it
    pre-transposed on the host at build time). The packed-table gather is
    the one gather, done along the LANE axis: `table[:, tri]` yields the
    (32, C) rows the downstream math reads directly, with no (C, 32)
    intermediate or layout copy.
    """
    if table is None:
        table = pack_table(scene).T
    t = jnp.where(hits.valid, hits.t, 0.0)
    tri = jnp.maximum(hits.tri, 0)
    g = table[:, tri]                      # (32, C) lane gather
    return prepare_packed_rows(scene.light_pos, rays, t, g, cfg)


def prepare_packed_rows(light_pos: jnp.ndarray, rays: jnp.ndarray,
                        t: jnp.ndarray, g: jnp.ndarray,
                        cfg: RenderConfig = DEFAULT_CONFIG) -> PackedPrep:
    """prepare_packed from pre-gathered table rows.

    `g` is (32, C) — the winning triangles' pack_table rows, transposed.
    The geometry-sharded paths (parallel/halo_bvh.py) gather these on the
    shard that OWNS the winning triangle and carry them home with the hit
    candidate, so no device ever holds the full (T, 32) table. `t` must
    already be zeroed for miss rays (keeps the hit-point math finite).
    """
    o, d = rays[0:3], rays[3:6]

    x = o + t[None, :] * d                 # (3, C)
    rel = x - g[0:3]
    u = jnp.sum(rel * g[3:6], axis=0)
    v = jnp.sum(rel * g[6:9], axis=0)
    r1 = 1.0 - u - v
    normal = _normalize_rows(r1[None, :] * g[9:12] + u[None, :] * g[12:15]
                             + v[None, :] * g[15:18])
    geo = g[18:21]

    zero = jnp.zeros((1, x.shape[1]), jnp.float32)
    qs, qrs = [], []
    for li in range(light_pos.shape[0]):
        lpos = light_pos[li]
        to_light = lpos[:, None] - x
        ldist = jnp.sqrt(jnp.sum(to_light * to_light, axis=0))
        ldir = to_light / ldist[None, :]
        side = jnp.where(jnp.sum(geo * ldir, axis=0) >= 0.0, 1.0, -1.0)
        origin = (x + cfg.shadow_offset * ldir
                  + (cfg.shadow_normal_offset * side)[None, :] * geo)
        tmax = (ldist - cfg.shadow_offset)[None, :]
        qs.append(jnp.concatenate([origin, ldir, tmax, zero], axis=0))
        # Reversed query: light -> offset surface point (see q_rev docs).
        back = origin - lpos[:, None]
        blen = jnp.sqrt(jnp.sum(back * back, axis=0, keepdims=True))
        bdir = back / jnp.where(blen > 0, blen, 1.0)
        lorg = jnp.broadcast_to(lpos[:, None], origin.shape)
        qrs.append(jnp.concatenate([lorg, bdir, blen, zero], axis=0))
    q = (jnp.stack(qs) if qs
         else jnp.zeros((0, 8, x.shape[1]), jnp.float32))
    q_rev = (jnp.stack(qrs) if qrs
             else jnp.zeros((0, 8, x.shape[1]), jnp.float32))
    return PackedPrep(x=x, normal=normal, geo_n=geo,
                      ka=g[21:24], kd=g[24:27], ks=g[27:30], ns=g[30],
                      q=q, q_rev=q_rev)


def light_gates(scene: SceneArrays, view: jnp.ndarray, prep: PackedPrep,
                valid: jnp.ndarray) -> jnp.ndarray:
    """(L, C) bool: can light li contribute a nonzero Phong term to ray c?

    Exactness-preserving shadow-work cull: when the potential contribution
    (kd*diff + ks*spec) * lcol is exactly zero on every channel — the light
    is behind the surface AND the specular lobe misses the viewer (or the
    material/light channels are zero) — the lit/shadowed answer cannot
    affect the image (shade_core_packed adds where(lit, contrib, 0) with
    contrib == 0), so the shadow query is skipped entirely. `view` must be
    the same viewer shade_core_packed will use so the gate matches the
    shading exactly.
    """
    return light_gates_rows(scene.light_col, view, prep, valid)


def light_gates_rows(light_col: jnp.ndarray, view: jnp.ndarray,
                     prep: PackedPrep, valid: jnp.ndarray) -> jnp.ndarray:
    """light_gates from the light-colour rows alone — the geometry-sharded
    paths (parallel/halo_bvh.py) carry no SceneArrays inside shard_map."""
    v = view[:, None] if view.ndim == 1 else view
    cam_dir = _normalize_rows(v - prep.x)
    gates = []
    for li in range(light_col.shape[0]):
        ldir = prep.q[li, 3:6]
        l_dot_n = jnp.sum(ldir * prep.normal, axis=0)
        diff = jnp.maximum(l_dot_n, 0.0)
        refl = 2.0 * l_dot_n[None, :] * prep.normal - ldir
        spec = jnp.power(
            jnp.maximum(jnp.sum(refl * cam_dir, axis=0), 0.0), prep.ns)
        contrib = ((prep.kd * diff[None, :] + prep.ks * spec[None, :])
                   * light_col[li][:, None])
        gates.append(valid & (jnp.max(contrib, axis=0) > 0.0))
    return (jnp.stack(gates) if gates
            else jnp.zeros((0, prep.x.shape[1]), bool))


def shade_core_packed(scene: SceneArrays, view: jnp.ndarray,
                      prep: PackedPrep, hits: intersect.Hits,
                      lit: jnp.ndarray) -> jnp.ndarray:
    """shade_core on PackedPrep; returns (3, C) colour rows.

    view: (3,) shared viewer (primary rays) or (3, C) per-ray (bounces).
    """
    return shade_core_rows(scene.light_col, view, prep, hits.valid, lit)


def shade_core_rows(light_col: jnp.ndarray, view: jnp.ndarray,
                    prep: PackedPrep, valid: jnp.ndarray,
                    lit: jnp.ndarray) -> jnp.ndarray:
    """shade_core_packed from light-colour rows + a validity mask (the
    geometry-sharded paths carry no SceneArrays/Hits inside shard_map)."""
    x, normal = prep.x, prep.normal
    ka, kd, ks, ns = prep.ka, prep.kd, prep.ks, prep.ns
    v = view[:, None] if view.ndim == 1 else view
    cam_dir = _normalize_rows(v - x)

    colour = ka
    for li in range(light_col.shape[0]):
        ldir = prep.q[li, 3:6]
        lcol = light_col[li]
        l_dot_n = jnp.sum(ldir * normal, axis=0)
        diff = jnp.maximum(l_dot_n, 0.0)
        refl = 2.0 * l_dot_n[None, :] * normal - ldir
        spec = jnp.power(
            jnp.maximum(jnp.sum(refl * cam_dir, axis=0), 0.0), ns)
        contrib = (kd * diff[None, :] + ks * spec[None, :]) * lcol[:, None]
        colour = colour + jnp.where(lit[li][None, :], contrib, 0.0)
    colour = jnp.minimum(colour, 1.0)  # saturating adds -> one clamp
    return jnp.where(valid[None, :], colour, 0.0)


def shade_core(scene: SceneArrays, cam_pos: jnp.ndarray, prep: ShadePrep,
               hits: intersect.Hits, lit: jnp.ndarray) -> jnp.ndarray:
    """Accumulate Phong lighting given per-light lit flags (L, C).

    cam_pos is the viewer position for the specular term — (3,) for primary
    rays (the camera, tracer.go:66) or (C, 3) per-ray for reflection bounces
    (the previous hit point)."""
    x, normal = prep.x, prep.normal
    ka, kd, ks, ns = prep.ka, prep.kd, prep.ks, prep.ns

    view = cam_pos[None, :] if cam_pos.ndim == 1 else cam_pos
    cam_dir = _normalize(view - x)  # V, toward the viewer

    def per_light(colour, light):
        ldir, l_lit, lcol = light
        l_dot_n = jnp.sum(ldir * normal, axis=-1)
        diff = jnp.maximum(l_dot_n, 0.0)
        refl = 2.0 * l_dot_n[:, None] * normal - ldir
        spec = jnp.power(jnp.maximum(jnp.sum(refl * cam_dir, axis=-1), 0.0), ns)
        contrib = (kd * diff[:, None] + ks * spec[:, None]) * lcol[None, :]
        return colour + jnp.where(l_lit[:, None], contrib, 0.0), None

    colour, _ = jax.lax.scan(
        per_light, ka, (prep.queries.ldir, lit, scene.light_col))
    colour = jnp.minimum(colour, 1.0)  # saturating adds collapsed to one clamp
    return jnp.where(hits.valid[:, None], colour, 0.0)


def shade(scene: SceneArrays, cam_pos: jnp.ndarray, origins: jnp.ndarray,
          dirs: jnp.ndarray, hits: intersect.Hits,
          cfg: RenderConfig = DEFAULT_CONFIG) -> jnp.ndarray:
    """Dense-path shading: answers shadow queries with intersect.any_hit.

    origins: (3,) shared or (C, 3); dirs: (C, 3); returns (C, 3) float32.
    Unhit rays are black (tracer.go:88-90).
    """
    prep = prepare(scene, origins, dirs, hits, cfg)

    def answer(q):
        origin, ldir, t_max = q
        return jnp.logical_not(
            intersect.any_hit(scene, origin, ldir, t_max, exclude=hits.tri))

    lit = jax.lax.map(answer, prep.queries)
    return shade_core(scene, cam_pos, prep, hits, lit)
