"""Block-sparse ray-triangle traversal: (ray tile, triangle block) work lists.

The hot path of the renderer: given a tile-major work list of (ray tile,
triangle block) pairs from ops/cull.py, evaluate the Baldwin–Weber
intersection for every (ray, triangle) pair of each listed block and fold
the results per ray into a nearest hit (t, lowest global id) or an any-hit
0/1 flag — the SpMV/BSR schedule from BASELINE.json, replacing the
reference's per-ray R-tree recursion (object.go:76, tracer.go:32).

Two implementations share one signature and contract:
  - `nearest_xla` / `any_xla`: plain jax.numpy/lax. Gathers the listed ray
    tiles and triangle blocks a chunk at a time, does the pair math over
    (chunk, tb, rt), reduces over tb and folds per tile with scatter-min.
    It is the reference for the kernels' tests and the CPU route.
  - `nearest_pallas` / `any_pallas`: Pallas kernels through Triton. Each
    tile's run of blocks is cut into segments of at most _SEG_ITEMS items
    (`tile_segments`); the grid is (segment, ray sub-block). A program
    reads its own segment bounds, loops over its blocks with the best hit
    kept in registers and writes one partial row; a small XLA fold
    combines the partial rows per tile with `init`.
`traversal_route()` picks one from the JAX backend; `bsr_nearest`/`bsr_any`
dispatch through it.

Contract (both routes):
  - Work items past `count` are ignored; tile_ids[:count] ascend.
  - Every ray of every tile gets an output: tiles absent from the list
    keep their `init` value (miss / not occluded by default).
  - Nearest ties fold to the lowest global id, so chained folds (ring and
    halo schedules pass `init_t`/`init_i`) are order-independent.
  - `gid_base` offsets reported ids (sharded geometry); `exclude` holds a
    per-ray global id that never hits (self-intersection of bounce and
    shadow rays).

Layouts (see pack helpers): rays [8, R] f32 rows (ox,oy,oz,dx,dy,dz,tmax,0);
triangles [T, 16] f32 columns (nx,ny,nz,plane_d, ku.xyz,c_u, kv.xyz,c_v,
0...). Boundary semantics identical to ops/intersect.py (same BARY_EPS
expansion).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from distributed_raytracer.ops.intersect import BARY_EPS

BIG_IDX = 2 ** 30      # plain int: jnp scalars would be captured tracer constants
# "Unbounded" packed t_max. Finite on purpose: every t <= t_max comparison
# behaves as with inf (t is at most scene-scale), and arithmetic on the
# packed rows never meets inf * 0 = NaN.
BIG_TMAX = 3.4e38

# Kernel shape constants (chosen on an H100, see PERF.md): rays per
# program, triangles per inner step, and Triton's warps/stages.
_RAY_BLOCK = 128
_TRI_STEP = 4
_NUM_WARPS = 4
_NUM_STAGES = 1
_SEG_ITEMS = 16        # work items per program at most (see tile_segments)
# Pair-math elements per chunk of the XLA route: bounds its (chunk, tb, rt)
# temporaries to 128 MB each whatever the work-list length.
_XLA_CHUNK_PAIRS = 1 << 25


def bucket_w_pad(n: int, margin: float = 1.0) -> int:
    """Static work-list capacity for a measured count.

    Small counts round to a power of two (few recompiles while a scene
    warms up); larger ones to a multiple of 2048, which wastes at most one
    granule of padding where power-of-two rounding could double it."""
    n = max(256, int(n * margin))
    if n <= 2048:
        return 1 << (n - 1).bit_length()
    return -(-n // 2048) * 2048


def traversal_route() -> str:
    """The traversal implementation for the default JAX backend: "pallas"
    (the Triton kernels) on a GPU, "xla" on the CPU."""
    backend = jax.default_backend()
    if backend == "gpu":
        return "pallas"
    if backend == "cpu":
        return "xla"
    raise RuntimeError(f"no traversal route for JAX backend {backend!r}")


# ---------------------------------------------------------------------------
# Packing helpers
# ---------------------------------------------------------------------------

def pack_tris(scene_arrays) -> np.ndarray:
    """[T, 16] float32 triangle columns for the traversal (static per
    scene)."""
    a = scene_arrays
    cols = [
        a.geo_n[:, 0], a.geo_n[:, 1], a.geo_n[:, 2], a.plane_d,
        a.k_u[:, 0], a.k_u[:, 1], a.k_u[:, 2], a.c_u,
        a.k_v[:, 0], a.k_v[:, 1], a.k_v[:, 2], a.c_v,
    ]
    t = a.p0.shape[0]
    packed = np.zeros((t, 16), dtype=np.float32)
    for i, c in enumerate(cols):
        packed[:, i] = np.asarray(c, np.float32)
    return packed


def pack_rays_rows(origins: jnp.ndarray, d_rows: jnp.ndarray,
                   t_max: jnp.ndarray | None = None) -> jnp.ndarray:
    """[8, R] rays from (3, R) direction rows. origins (3, R) rows or (3,)
    shared."""
    r = d_rows.shape[1]
    o = (jnp.broadcast_to(origins[:, None], (3, r))
         if origins.ndim == 1 else origins)
    tmax = (jnp.full((1, r), BIG_TMAX, jnp.float32)
            if t_max is None else t_max.reshape(1, r))
    zero = jnp.zeros((1, r), jnp.float32)
    return jnp.concatenate([o, d_rows, tmax, zero], axis=0)


@jax.jit
def pack_tris_origin(tris_packed: jnp.ndarray,
                     origin: jnp.ndarray) -> jnp.ndarray:
    """Per-frame triangle rows for the shared-origin traversal.

    When every ray in a launch has the SAME origin o (primary rays from the
    camera; shadow rays reversed to start at their point light), the
    origin-dependent dot products of Baldwin-Weber are per-triangle scalars:
        num  = plane_d - n.o        (t = num / n.d)
        a_u  = k_u.o + c_u          (u = a_u + t * k_u.d)
        a_v  = k_v.o + c_v
    Precomputing them here (one tiny dense op over all T triangles) removes
    about a quarter of the per-(ray, tri) work.

    Input: the static (T, 16) pack_tris columns. Output columns:
      [nx, ny, nz, num, kux, kuy, kuz, a_u, kvx, kvy, kvz, a_v, 0...]
    """
    o = origin.reshape(1, 3)
    n, pd = tris_packed[:, 0:3], tris_packed[:, 3:4]
    ku, cu = tris_packed[:, 4:7], tris_packed[:, 7:8]
    kv, cv = tris_packed[:, 8:11], tris_packed[:, 11:12]
    num = pd - jnp.sum(n * o, axis=1, keepdims=True)
    au = jnp.sum(ku * o, axis=1, keepdims=True) + cu
    av = jnp.sum(kv * o, axis=1, keepdims=True) + cv
    pad = jnp.zeros((tris_packed.shape[0], 4), jnp.float32)
    return jnp.concatenate([n, num, ku, au, kv, av, pad], axis=1)


def lights_origin_packs(tris_packed: jnp.ndarray,
                        light_pos: jnp.ndarray) -> jnp.ndarray:
    """(L*T, 16): pack_tris_origin for every light, stacked — light l's
    rows at [l*T, (l+1)*T), so its blocks are offset by l * (T // tb)."""
    if light_pos.shape[0] == 0:
        return jnp.zeros((0, 16), jnp.float32)
    return jnp.concatenate([pack_tris_origin(tris_packed, light_pos[li])
                            for li in range(light_pos.shape[0])], axis=0)


def tile_offsets(tile_ids: jnp.ndarray, count, n_tiles: int) -> jnp.ndarray:
    """(n_tiles + 1,) int32 run bounds of a tile-major work list: tile t's
    items are [off[t], off[t + 1]). Items past `count` belong to no tile."""
    slot = jnp.arange(tile_ids.shape[0], dtype=jnp.int32)
    real = jnp.where(slot < count, tile_ids, n_tiles)
    return jnp.searchsorted(real, jnp.arange(n_tiles + 1, dtype=jnp.int32),
                            side="left").astype(jnp.int32)


# ---------------------------------------------------------------------------
# Pair math (shared by both routes)
# ---------------------------------------------------------------------------

def _pair_math(row, col, shared_origin: bool):
    """Baldwin–Weber over a block of (triangle, ray) pairs: (t, valid).

    `row(k)` returns ray row k broadcastable along the ray axis, `col(c)`
    triangle column c broadcastable along the triangle axis. With
    shared_origin the columns are the pack_tris_origin layout (num/a_u/a_v
    folded with the common origin); otherwise the pack_tris layout with
    per-ray origins from rows 0..2.
    """
    dx, dy, dz = row(3), row(4), row(5)
    nx, ny, nz = col(0), col(1), col(2)
    kux, kuy, kuz = col(4), col(5), col(6)
    kvx, kvy, kvz = col(8), col(9), col(10)

    den = nx * dx + ny * dy + nz * dz
    if shared_origin:
        t = col(3) / den                         # num / n.d
        u = col(7) + t * (kux * dx + kuy * dy + kuz * dz)
        v = col(11) + t * (kvx * dx + kvy * dy + kvz * dz)
    else:
        ox, oy, oz = row(0), row(1), row(2)
        o_n = nx * ox + ny * oy + nz * oz
        t = (col(3) - o_n) / den
        u = ((kux * ox + kuy * oy + kuz * oz + col(7))
             + t * (kux * dx + kuy * dy + kuz * dz))
        v = ((kvx * ox + kvy * oy + kvz * oz + col(11))
             + t * (kvx * dx + kvy * dy + kvz * dz))

    eps = BARY_EPS
    valid = ((den != 0.0) & (t >= 0.0)
             & (u >= -eps) & (u <= 1.0 + eps)
             & (u + v >= -eps) & (u + v <= 1.0 + eps)
             & (v >= -eps))
    return t, valid


def _prep(rays, exclude, count, gid_base, w: int):
    count = jnp.int32(w) if count is None else jnp.asarray(count, jnp.int32)
    gid_base = (jnp.zeros((1,), jnp.int32) if gid_base is None
                else jnp.asarray(gid_base, jnp.int32).reshape(1))
    return rays, exclude.astype(jnp.int32), count, gid_base


# ---------------------------------------------------------------------------
# XLA route
# ---------------------------------------------------------------------------

def _xla_traverse(reduce, combine, carry, rays, exclude, tris, tile_ids,
                  block_ids, count, gid_base, *, rt: int, tb: int,
                  shared_origin: bool):
    """Scan the work list in chunks: `reduce(t, valid, gid, tmax)` folds a
    chunk's (C, tb, rt) pairs over tb, `combine(carry, tile ids (C,), ...)`
    folds the (C, rt) results into the (n_tiles, rt) carry."""
    r = rays.shape[1]
    nt = r // rt
    w = tile_ids.shape[0]
    c = min(w, max(1, _XLA_CHUNK_PAIRS // (tb * rt)))
    n_chunks = -(-w // c)
    pad = n_chunks * c - w
    live = (jnp.arange(n_chunks * c, dtype=jnp.int32) < count)
    tids = jnp.pad(tile_ids, (0, pad)).reshape(n_chunks, c)
    bids = jnp.pad(block_ids, (0, pad)).reshape(n_chunks, c)
    live = live.reshape(n_chunks, c)
    rays_t = rays.reshape(8, nt, rt).transpose(1, 0, 2)        # (nt, 8, rt)
    excl_t = exclude.reshape(nt, rt)
    tris_b = tris.reshape(-1, tb, 16)
    lane = jnp.arange(tb, dtype=jnp.int32)[None, :, None]

    def body(carry, xs):
        tid, bid, lv = xs
        rg = rays_t[tid]                                       # (C, 8, rt)
        tg = tris_b[bid]                                       # (C, tb, 16)
        t, valid = _pair_math(lambda k: rg[:, k:k + 1, :],
                              lambda k: tg[:, :, k:k + 1], shared_origin)
        gid = gid_base[0] + bid[:, None, None] * tb + lane
        valid = (valid & (gid != excl_t[tid][:, None, :])
                 & lv[:, None, None])
        return combine(carry, tid, *reduce(t, valid, gid, rg[:, 6:7, :])), None

    carry, _ = jax.lax.scan(body, carry, (tids, bids, live))
    return carry


def _reduce_nearest(t, valid, gid, tmax):
    """(C, tb, rt) pairs -> per-item (best t, its lowest id), (C, rt)."""
    cand = jnp.where(valid, t, jnp.inf)
    m = cand.min(axis=1)
    sel = jnp.where(valid & (cand == m[:, None, :]), gid,
                    BIG_IDX).min(axis=1)
    return m, sel


def _reduce_any(t, valid, gid, tmax):
    return (jnp.any(valid & (t <= tmax), axis=1).astype(jnp.int32),)


def _combine_nearest(carry, tid, m, sel):
    """Fold per-item (m, sel) rows into the per-tile (t, id) carry: min t,
    then the lowest id among the rows that reach it."""
    bt, bi = carry
    new_t = bt.at[tid].min(m)
    # The old id survives only where the best t did not move.
    cand_i = jnp.where(m == new_t[tid], sel, BIG_IDX)
    new_i = jnp.where(new_t == bt, bi, BIG_IDX).at[tid].min(cand_i)
    return new_t, new_i


def _combine_any(hit, tid, h):
    return hit.at[tid].max(h)


def _inits_nearest(init_t, init_i, r: int, rt: int):
    return (_init(init_t, r, jnp.inf, jnp.float32).reshape(r // rt, rt),
            _init(init_i, r, BIG_IDX, jnp.int32).reshape(r // rt, rt))


def _init_any(init, r: int, rt: int):
    return (_init(init, r, 0, jnp.int32) != 0).astype(jnp.int32).reshape(
        r // rt, rt)


def nearest_xla(rays_packed, exclude, tris_packed, tile_ids, block_ids,
                count=None, init_t=None, init_i=None, gid_base=None, *,
                rt: int, tb: int, shared_origin: bool = False):
    """Plain-XLA nearest hit over the work list: (best_t (R,), best_id (R,))."""
    rays, excl, count, gid_base = _prep(rays_packed, exclude, count,
                                        gid_base, tile_ids.shape[0])
    r = rays.shape[1]
    bt, bi = _xla_traverse(_reduce_nearest, _combine_nearest,
                           _inits_nearest(init_t, init_i, r, rt), rays, excl,
                           tris_packed, tile_ids, block_ids, count, gid_base,
                           rt=rt, tb=tb, shared_origin=shared_origin)
    return bt.reshape(r), bi.reshape(r)


def any_xla(rays_packed, exclude, tris_packed, tile_ids, block_ids,
            count=None, init=None, gid_base=None, *, rt: int, tb: int,
            shared_origin: bool = False):
    """Plain-XLA any-hit (shadow) query with per-ray t_max: int32 (R,) 0/1."""
    rays, excl, count, gid_base = _prep(rays_packed, exclude, count,
                                        gid_base, tile_ids.shape[0])
    r = rays.shape[1]
    hit = _xla_traverse(_reduce_any, _combine_any, _init_any(init, r, rt),
                        rays, excl, tris_packed, tile_ids, block_ids, count,
                        gid_base, rt=rt, tb=tb, shared_origin=shared_origin)
    return hit.reshape(r)


def _init(v, r: int, fill, dtype):
    return (jnp.full((r,), fill, dtype) if v is None
            else jnp.asarray(v).reshape(r).astype(dtype))


# ---------------------------------------------------------------------------
# Pallas (Triton) route
# ---------------------------------------------------------------------------

def _ray_block(rt: int) -> int:
    """Largest power of two <= _RAY_BLOCK that divides rt."""
    rb = rt & -rt
    return min(rb, _RAY_BLOCK)


def tile_segments(tile_ids, count, n_tiles: int, seg_items: int):
    """Split every tile's run into segments of at most `seg_items` items:
    (3, S) int32 rows [start, end, tile] with S = W // seg_items + min(
    n_tiles, W), enough for any tile-major list of W items. Unused
    segments are empty ranges on tile n_tiles - 1."""
    w = tile_ids.shape[0]
    n_seg = w // seg_items + min(n_tiles, w)
    off = tile_offsets(tile_ids, count, n_tiles)
    per_tile = (off[1:] - off[:-1] + seg_items - 1) // seg_items
    seg_off = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                               jnp.cumsum(per_tile).astype(jnp.int32)])
    s = jnp.arange(n_seg, dtype=jnp.int32)
    tile = jnp.searchsorted(seg_off, s, side="right").astype(jnp.int32) - 1
    used = tile < n_tiles
    tile = jnp.minimum(tile, n_tiles - 1)
    start = off[tile] + (s - seg_off[tile]) * seg_items
    end = jnp.minimum(start + seg_items, off[tile + 1])
    return jnp.stack([jnp.where(used, start, 0), jnp.where(used, end, 0),
                      tile])


def _segment_rows(seg_ref, rays_ref, excl_ref, rt: int, rb: int, n: int):
    s, j = pl.program_id(0), pl.program_id(1)
    start, end, tile = seg_ref[0, s], seg_ref[1, s], seg_ref[2, s]
    c0 = tile * rt + j * rb
    rows = [rays_ref[pl.ds(k, 1), pl.ds(c0, rb)] for k in range(n)]
    return start, end, rows, excl_ref[:, pl.ds(c0, rb)]


def _nearest_kernel(seg_ref, block_ids_ref, gid_base_ref, rays_ref,
                    excl_ref, tris_ref, out_t_ref, out_i_ref, *, rt: int,
                    tb: int, sub: int, shared_origin: bool):
    rb = out_t_ref.shape[1]
    start, end, rows, excl = _segment_rows(seg_ref, rays_ref, excl_ref, rt,
                                           rb, 6)
    gid_base = gid_base_ref[0]
    lane = jax.lax.broadcasted_iota(jnp.int32, (sub, 1), 0)
    # (sub, rb) carries: each row keeps its own best, reduced once at the
    # end, so the inner loop needs no cross-lane reduction.
    best = (jnp.full((sub, rb), jnp.inf, jnp.float32),
            jnp.full((sub, rb), BIG_IDX, jnp.int32))

    def item(w, carry):
        blk = block_ids_ref[w]

        def step(s, carry):
            bt, bi = carry
            r0 = blk * tb + s * sub
            t, valid = _pair_math(
                lambda k: rows[k],
                lambda c: tris_ref[pl.ds(r0, sub), pl.ds(c, 1)],
                shared_origin)
            gid = gid_base + r0 + lane
            better = valid & (gid != excl) & (
                (t < bt) | ((t == bt) & (gid < bi)))
            return jnp.where(better, t, bt), jnp.where(better, gid, bi)

        return jax.lax.fori_loop(0, tb // sub, step, carry)

    bt, bi = jax.lax.fori_loop(start, end, item, best)
    m = jnp.min(bt, axis=0, keepdims=True)
    out_t_ref[...] = m
    out_i_ref[...] = jnp.min(jnp.where(bt == m, bi, BIG_IDX), axis=0,
                             keepdims=True)


def _any_kernel(seg_ref, block_ids_ref, gid_base_ref, rays_ref, excl_ref,
                tris_ref, out_ref, *, rt: int, tb: int, sub: int,
                shared_origin: bool):
    rb = out_ref.shape[1]
    start, end, rows, excl = _segment_rows(seg_ref, rays_ref, excl_ref, rt,
                                           rb, 7)
    gid_base = gid_base_ref[0]
    lane = jax.lax.broadcasted_iota(jnp.int32, (sub, 1), 0)

    def item(w, hit):
        blk = block_ids_ref[w]

        def step(s, hit):
            r0 = blk * tb + s * sub
            t, valid = _pair_math(
                lambda k: rows[k],
                lambda c: tris_ref[pl.ds(r0, sub), pl.ds(c, 1)],
                shared_origin)
            gid = gid_base + r0 + lane
            h = valid & (gid != excl) & (t <= rows[6])
            return jnp.where(h, 1, hit)

        return jax.lax.fori_loop(0, tb // sub, step, hit)

    hit = jax.lax.fori_loop(start, end, item,
                            jnp.zeros((sub, rb), jnp.int32))
    out_ref[...] = jnp.max(hit, axis=0, keepdims=True)


def _pallas_segments(kernel, out_dtypes, rays, exclude, tris, tile_ids,
                     block_ids, count, gid_base, *, rt: int, tb: int,
                     shared_origin: bool, interpret: bool):
    """Per-segment partial results (S, rt) and the segments' tiles (S,).
    Segments, not tiles, are the grid's rows: a silhouette tile's long run
    spreads over many programs instead of serializing on one."""
    r = rays.shape[1]
    rb = _ray_block(rt)
    seg = tile_segments(tile_ids, count, r // rt, _SEG_ITEMS)
    n_seg = seg.shape[1]
    whole = pl.no_block_spec
    out_spec = pl.BlockSpec((1, rb), lambda s, j: (s, j))
    outs = pl.pallas_call(
        functools.partial(kernel, rt=rt, tb=tb,
                          sub=min(_TRI_STEP, tb & -tb),
                          shared_origin=shared_origin),
        out_shape=tuple(jax.ShapeDtypeStruct((n_seg, rt), d)
                        for d in out_dtypes),
        grid=(n_seg, rt // rb),
        in_specs=[whole] * 6,
        out_specs=tuple(out_spec for _ in out_dtypes),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=_NUM_WARPS,
                                                 num_stages=_NUM_STAGES),
        interpret=interpret,
        name=kernel.__name__.strip("_"),
    )(seg, block_ids.astype(jnp.int32), gid_base, rays,
      exclude.reshape(1, r), tris)
    return outs, seg[2]


def nearest_pallas(rays_packed, exclude, tris_packed, tile_ids, block_ids,
                   count=None, init_t=None, init_i=None, gid_base=None, *,
                   rt: int, tb: int,
                   shared_origin: bool = False, interpret: bool = False):
    """nearest_xla's contract, as a Triton kernel plus a per-tile fold."""
    rays, excl, count, gid_base = _prep(rays_packed, exclude, count,
                                        gid_base, tile_ids.shape[0])
    r = rays.shape[1]
    (m, sel), seg_tile = _pallas_segments(
        _nearest_kernel, (jnp.float32, jnp.int32), rays, excl, tris_packed,
        tile_ids, block_ids, count, gid_base, rt=rt, tb=tb,
        shared_origin=shared_origin, interpret=interpret)
    bt, bi = _combine_nearest(_inits_nearest(init_t, init_i, r, rt),
                              seg_tile, m, sel)
    return bt.reshape(r), bi.reshape(r)


def any_pallas(rays_packed, exclude, tris_packed, tile_ids, block_ids,
               count=None, init=None, gid_base=None, *, rt: int, tb: int,
               shared_origin: bool = False, interpret: bool = False):
    """any_xla's contract, as a Triton kernel plus a per-tile fold."""
    rays, excl, count, gid_base = _prep(rays_packed, exclude, count,
                                        gid_base, tile_ids.shape[0])
    r = rays.shape[1]
    (h,), seg_tile = _pallas_segments(
        _any_kernel, (jnp.int32,), rays, excl, tris_packed, tile_ids,
        block_ids, count, gid_base, rt=rt, tb=tb,
        shared_origin=shared_origin, interpret=interpret)
    return _combine_any(_init_any(init, r, rt), seg_tile, h).reshape(r)


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("rt", "tb", "shared_origin"))
def bsr_nearest(rays_packed, exclude, tris_packed, tile_ids, block_ids,
                count=None, init_t=None, init_i=None, gid_base=None, *,
                rt: int, tb: int, shared_origin: bool = False):
    """Nearest hit over the work list: (best_t (R,), best_id (R,)).

    `count` = number of real work items (None = all). With
    shared_origin=True, tris_packed must be the pack_tris_origin layout for
    the launch's common ray origin. See the module docstring for the
    contract; the route comes from traversal_route().
    """
    fn = nearest_pallas if traversal_route() == "pallas" else nearest_xla
    return fn(rays_packed, exclude, tris_packed, tile_ids, block_ids,
              count, init_t, init_i, gid_base, rt=rt, tb=tb,
              shared_origin=shared_origin)


@functools.partial(jax.jit, static_argnames=("rt", "tb", "shared_origin"))
def bsr_any(rays_packed, exclude, tris_packed, tile_ids, block_ids,
            count=None, init=None, gid_base=None, *, rt: int, tb: int,
            shared_origin: bool = False):
    """Any-hit (shadow) query with per-ray t_max. Returns int32 (R,) 0/1.

    `init` (R,) pre-seeds the result (dead rays — misses, zero-Ks — arrive
    as already occluded; callers mask them out anyway). It also chains
    ring-rotation steps (parallel/ring_bvh.py).
    """
    fn = any_pallas if traversal_route() == "pallas" else any_xla
    return fn(rays_packed, exclude, tris_packed, tile_ids, block_ids,
              count, init, gid_base, rt=rt, tb=tb,
              shared_origin=shared_origin)
