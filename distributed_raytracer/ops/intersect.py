"""Batched ray-triangle intersection (dense path).

The reference intersects one ray against one triangle at a time with
Möller–Trumbore (shared/geom/triangle.go:37-77). The array formulation is a
dense rays×triangles sweep using precomputed per-triangle plane/barycentric
projectors (Baldwin–Weber style, baked in models/scene.py), so the inner loop
is three batched dot products — expressed as [C,3]x[3,T] matmuls — plus
elementwise masking and an argmin reduction.

Boundary semantics match triangle.go exactly (inclusive 0/1 bounds, den != 0,
t >= 0, no backface culling):
    den = n . d          (triangle.go:46 `incidence` = -den; != 0 required)
    t   = (plane_d - n . o) / den,  t >= 0        (triangle.go:68-71)
    u   = (o . k_u + c_u) + t * (d . k_u),  0 <= u <= 1       (r2, :52-55)
    v   = (o . k_v + c_v) + t * (d . k_v),  0 <= u + v <= 1, v >= 0 (r3, :58-66)

Nearest-hit selection is by ray parameter t (distance from the ray origin,
since directions are unit length). For primary rays this is identical to the
reference, whose distances are measured from the camera (tracer.go:38). For
shadow rays the reference *also* measures from the camera across objects — a
quirk that can mislabel shadows when overlapping objects straddle the light;
we deliberately use origin distance (the physically meaningful choice) and
document the divergence here.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from distributed_raytracer.models.scene import SceneArrays

INF = float("inf")  # plain float: keeps package import backend-free

# Barycentric inclusion tolerance for float32 watertightness (see
# _pair_quantities). Sized to dominate |x|*|k|*2^-23 rounding for scene
# coordinates up to O(100) units.
BARY_EPS = 1e-4


class Hits(NamedTuple):
    t: jnp.ndarray      # (C,) ray parameter of nearest hit (inf if none)
    tri: jnp.ndarray    # (C,) int32 triangle index (garbage if no hit)
    valid: jnp.ndarray  # (C,) bool


def _pair_quantities(scene: SceneArrays, origins: jnp.ndarray, dirs: jnp.ndarray):
    """Per (ray, tri) t/u/v/valid arrays, shape (C, T).

    origins: (C, 3) or (3,) shared origin; dirs: (C, 3) unit directions.
    """
    n_t = scene.geo_n.T          # (3, T)
    ku_t = scene.k_u.T
    kv_t = scene.k_v.T

    # Ray-dependent dots: matmuls (C,3)@(3,T). Precision HIGHEST is
    # load-bearing: a default-precision f32 matmul may run in TF32 or
    # bfloat16 passes, which corrupts hit tests (wrong nearest triangle,
    # edge misses). HIGHEST keeps full f32 accuracy.
    mm = lambda a, b: jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)
    den = mm(dirs, n_t)          # (C, T)
    d_ku = mm(dirs, ku_t)
    d_kv = mm(dirs, kv_t)

    if origins.ndim == 1:  # shared origin (primary rays): per-tri scalars
        o_n = mm(origins, n_t)[None, :]
        o_ku = mm(origins, ku_t)[None, :]
        o_kv = mm(origins, kv_t)[None, :]
    else:
        o_n = mm(origins, n_t)
        o_ku = mm(origins, ku_t)
        o_kv = mm(origins, kv_t)

    t = (scene.plane_d[None, :] - o_n) / den
    u = (o_ku + scene.c_u[None, :]) + t * d_ku
    v = (o_kv + scene.c_v[None, :]) + t * d_kv

    # Inclusion bounds are epsilon-expanded: with exact bounds (the float64
    # reference's 0<=r<=1, triangle.go:52-66) float32 rounding lets rays on a
    # shared edge be rejected by BOTH adjacent triangles ("cracks" — black
    # pixel speckle along mesh edges). Expanding by BARY_EPS turns cracks
    # into harmless double-hits: the nearest-hit argmin picks either side,
    # and interpolated shading is continuous across the edge. Documented
    # float32 divergence; the oracle keeps exact semantics.
    eps = BARY_EPS
    valid = (
        (den != 0.0)
        & (t >= 0.0)
        & (u >= -eps) & (u <= 1.0 + eps)
        & (u + v >= -eps) & (u + v <= 1.0 + eps)
        & (v >= -eps)
    )
    return t, u, v, valid


def nearest_hit(scene: SceneArrays, origins: jnp.ndarray, dirs: jnp.ndarray,
                exclude: jnp.ndarray | None = None) -> Hits:
    """Nearest intersection of each ray with the whole triangle soup.

    The dense analog of tracer.go:27-50 / object.go:63-110's two-level R-tree
    query: every triangle is tested; the R-tree's pruning role is taken over
    by the block-BVH kernels in ops/pallas (for large scenes).

    `exclude` masks a per-ray triangle (the surface a secondary ray starts
    on) — the float32 analog of the reference's origin offset (tracer.go:64).
    """
    t, _, _, valid = _pair_quantities(scene, origins, dirs)
    if exclude is not None:
        tri_ids = jnp.arange(scene.num_tris, dtype=jnp.int32)[None, :]
        valid = valid & (tri_ids != exclude[:, None])
    cand = jnp.where(valid, t, INF)
    tri = jnp.argmin(cand, axis=1).astype(jnp.int32)
    tmin = jnp.take_along_axis(cand, tri[:, None], axis=1)[:, 0]
    return Hits(t=tmin, tri=tri, valid=jnp.isfinite(tmin))


def any_hit(scene: SceneArrays, origins: jnp.ndarray, dirs: jnp.ndarray,
            t_max: jnp.ndarray, exclude: jnp.ndarray | None = None) -> jnp.ndarray:
    """True where some triangle is hit with t <= t_max (shadow query).

    Equivalent to the reference's shadow test (tracer.go:64): "nearest hit at
    distance <= light distance" iff "any hit at distance <= light distance".

    `exclude` (per-ray int32 triangle index) masks out the triangle the
    shadow ray originates on. The float64 reference relies on the 1e-4
    origin offset alone (tracer.go:64); in float32 that offset does not
    always clear the originating surface (shadow acne), so self-exclusion
    restores the reference's intended semantics at working precision.
    """
    t, _, _, valid = _pair_quantities(scene, origins, dirs)
    if exclude is not None:
        tri_ids = jnp.arange(scene.num_tris, dtype=jnp.int32)[None, :]
        valid = valid & (tri_ids != exclude[:, None])
    return jnp.any(valid & (t <= t_max[:, None]), axis=1)


def barycentrics_at(scene: SceneArrays, origins: jnp.ndarray, dirs: jnp.ndarray,
                    t: jnp.ndarray, tri: jnp.ndarray):
    """Recompute (u, v) for the winning triangle of each ray.

    Cheaper than materializing (C, T) barycentric arrays in nearest_hit: the
    winner's data is gathered ((C,3) rows) and u/v evaluated per ray.
    """
    k_u = scene.k_u[tri]     # (C, 3)
    k_v = scene.k_v[tri]
    p0 = scene.p0[tri]
    if origins.ndim == 1:
        origins = origins[None, :]
    x = origins + t[:, None] * dirs  # hit points
    # (x - p0) . k is better conditioned than x . k + c: the relative vector
    # is edge-scale, avoiding the large-coordinate cancellation of c_u/c_v.
    rel = x - p0
    u = jnp.sum(rel * k_u, axis=-1)
    v = jnp.sum(rel * k_v, axis=-1)
    return u, v, x
