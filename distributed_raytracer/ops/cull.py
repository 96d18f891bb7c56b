"""Conservative ray-tile vs triangle-block culling.

The array-program replacement for R-tree traversal predicates
(shared/geom/box.go:29-69 Box.Intersect driving rtreego SearchCondition):
instead of per-ray pointer-chasing, rays are grouped into tiles, each tile is
summarized by componentwise origin/direction intervals, and one *interval
arithmetic* slab test per (tile, block) conservatively decides whether any
ray in the tile can hit the block's AABB. False positives cost only wasted
dense work; false negatives are impossible (the test is conservative), so
images are exact.

The surviving (tile, block) pairs are compacted into a flat work list — the
BSR/SpMV schedule consumed by ops/pallas/bsr_trace.py.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp

INF = float("inf")  # plain float: keeps package import backend-free


class TileIntervals(NamedTuple):
    o_lo: jnp.ndarray   # (nT, 3)
    o_hi: jnp.ndarray   # (nT, 3)
    d_lo: jnp.ndarray   # (nT, 3)
    d_hi: jnp.ndarray   # (nT, 3)
    t_hi: jnp.ndarray   # (nT,) max t of interest per tile (inf if unbounded)


def tile_intervals(origins: jnp.ndarray, dirs: jnp.ndarray, tile: int,
                   t_max: Optional[jnp.ndarray] = None,
                   live: Optional[jnp.ndarray] = None) -> TileIntervals:
    """Componentwise bounds of each tile's rays. origins (R,3) or (3,) shared;
    dirs (R,3); R must be a multiple of `tile`.

    `live` (R,) bool masks rays out of the hull (dead secondary rays — misses,
    zero-Ks materials). A tile with no live ray gets an inverted (+inf, -inf)
    hull whose slab quotients are NaN, so every comparison in
    block_mask_with_entry is False and the tile culls to zero work — no
    gather/collapse of dead rays onto live ones is needed.
    """
    r = dirs.shape[0]
    nt = r // tile
    d = dirs.reshape(nt, tile, 3)
    if live is not None:
        lv = live.reshape(nt, tile, 1)
        d_lo = jnp.where(lv, d, INF).min(axis=1)
        d_hi = jnp.where(lv, d, -INF).max(axis=1)
    else:
        d_lo, d_hi = d.min(axis=1), d.max(axis=1)
    if origins.ndim == 1:
        o_lo = jnp.broadcast_to(origins[None, :], (nt, 3))
        o_hi = o_lo
    elif live is not None:
        o = origins.reshape(nt, tile, 3)
        lv = live.reshape(nt, tile, 1)
        o_lo = jnp.where(lv, o, INF).min(axis=1)
        o_hi = jnp.where(lv, o, -INF).max(axis=1)
    else:
        o = origins.reshape(nt, tile, 3)
        o_lo, o_hi = o.min(axis=1), o.max(axis=1)
    if t_max is None:
        t_hi = jnp.full((nt,), INF)
    elif live is not None:
        t_hi = jnp.where(live, t_max, 0.0).reshape(nt, tile).max(axis=1)
    else:
        t_hi = t_max.reshape(nt, tile).max(axis=1)
    return TileIntervals(o_lo=o_lo, o_hi=o_hi, d_lo=d_lo, d_hi=d_hi, t_hi=t_hi)


def tile_intervals_packed(rays: jnp.ndarray, tile: int,
                          live: Optional[jnp.ndarray] = None,
                          use_tmax: bool = False) -> TileIntervals:
    """tile_intervals for packed (8, R) ray rows (ox,oy,oz,dx,dy,dz,tmax,·).

    Row-major reductions keep every coordinate a dense (R,) lane vector —
    no (R, 3) layout copies. Row 6 (t_max) participates only when
    `use_tmax` (nearest queries are unbounded)."""
    r = rays.shape[1]
    nt = r // tile
    big = jnp.float32(jnp.inf)

    def lohi(rows):  # (3, R) -> (nt, 3), (nt, 3)
        v = rows.reshape(3, nt, tile)
        if live is not None:
            lv = live.reshape(1, nt, tile)
            lo = jnp.where(lv, v, big).min(axis=2)
            hi = jnp.where(lv, v, -big).max(axis=2)
        else:
            lo, hi = v.min(axis=2), v.max(axis=2)
        return lo.T, hi.T

    o_lo, o_hi = lohi(rays[0:3])
    d_lo, d_hi = lohi(rays[3:6])
    if use_tmax:
        tm = rays[6]
        if live is not None:
            tm = jnp.where(live, tm, 0.0)
        t_hi = tm.reshape(nt, tile).max(axis=1)
    else:
        t_hi = jnp.full((nt,), big)
        if live is not None:
            # all-dead tiles must still cull to nothing
            t_hi = jnp.where(live.reshape(nt, tile).any(axis=1), big, 0.0)
    return TileIntervals(o_lo=o_lo, o_hi=o_hi, d_lo=d_lo, d_hi=d_hi, t_hi=t_hi)


def block_mask_with_entry(ti: TileIntervals, block_lo: jnp.ndarray,
                          block_hi: jnp.ndarray):
    """Conservative (nTiles, NB) cull with entry distances.

    Per axis, the slab crossing times of every (origin, direction) in the
    tile's interval hull lie within the interval quotient [A,B]/[d_lo,d_hi];
    if the direction interval straddles 0 the quotient is (-inf, inf)
    (fully conservative). A block is kept iff the intersection of the three
    axis intervals meets [0, t_hi]. Blocks of pure padding have inverted
    AABBs (+inf, -inf) and never pass.

    Also returns each cell's conservative entry distance (a lower bound on
    any tile ray's entry into the block AABB) — the front-to-back sort key
    and early-exit bound for the traversal kernels.
    """
    # Shapes: tiles on axis 0, blocks on axis 1, xyz on axis 2.
    a = block_lo[None, :, :] - ti.o_hi[:, None, :]   # (nT, NB, 3)
    b = block_hi[None, :, :] - ti.o_lo[:, None, :]
    d_lo = ti.d_lo[:, None, :]
    d_hi = ti.d_hi[:, None, :]

    straddle = (d_lo <= 0.0) & (d_hi >= 0.0)
    # Quotient extremes over the four corner combinations (safe where the
    # direction interval excludes zero; straddling axes are overridden).
    q1 = a / jnp.where(d_lo == 0.0, 1.0, d_lo)
    q2 = a / jnp.where(d_hi == 0.0, 1.0, d_hi)
    q3 = b / jnp.where(d_lo == 0.0, 1.0, d_lo)
    q4 = b / jnp.where(d_hi == 0.0, 1.0, d_hi)
    t_lo_axis = jnp.minimum(jnp.minimum(q1, q2), jnp.minimum(q3, q4))
    t_hi_axis = jnp.maximum(jnp.maximum(q1, q2), jnp.maximum(q3, q4))
    t_lo_axis = jnp.where(straddle, -INF, t_lo_axis)
    t_hi_axis = jnp.where(straddle, INF, t_hi_axis)

    enter = jnp.maximum(t_lo_axis.max(axis=2), 0.0)
    exit_ = jnp.minimum(t_hi_axis.min(axis=2), ti.t_hi[:, None])
    # Inverted (+inf, -inf) padding boxes do NOT fail the quotient math
    # (a=+inf, b=-inf spans every axis interval to (-inf, +inf)), so they
    # must be rejected explicitly — a passing phantom superblock member
    # expands to out-of-range block ids and out-of-bounds reads in the
    # traversal.
    valid = (block_lo <= block_hi).all(axis=1)[None, :]
    return (enter <= exit_) & valid, enter


def block_mask(ti: TileIntervals, block_lo: jnp.ndarray,
               block_hi: jnp.ndarray) -> jnp.ndarray:
    """Conservative (nTiles, NB) bool: could any tile ray hit block AABB?"""
    return block_mask_with_entry(ti, block_lo, block_hi)[0]


def tiled_ray_order(width: int, height: int, tile_w: int, tile_h: int):
    """Static pixel permutation grouping rays into 2D screen tiles.

    Row-major flat indexing makes a 512-ray tile a 512x1 pixel *strip* —
    terrible spatial locality for interval culling. This permutation makes
    each tile a tile_w x tile_h rectangle (the reference's WorkOrder
    rectangles, master/main.go:54-91, reborn as a memory layout).

    Returns (perm, inv_real, n_slots):
      perm[s]      -> flat row-major pixel index for ray slot s (clamped
                      duplicates for out-of-frame padding slots)
      inv_real[p]  -> ray slot of real pixel p (for framebuffer assembly)
      n_slots      = padded slot count (multiple of tile_w*tile_h)
    """
    import numpy as np

    tx = -(-width // tile_w)
    ty = -(-height // tile_h)
    n_slots = tx * ty * tile_w * tile_h

    s = np.arange(n_slots)
    tile = s // (tile_w * tile_h)
    within = s % (tile_w * tile_h)
    tj, ti = tile // tx, tile % tx
    wj, wi = within // tile_w, within % tile_w
    j = np.minimum(tj * tile_h + wj, height - 1)
    i = np.minimum(ti * tile_w + wi, width - 1)
    perm = (j * width + i).astype(np.int32)

    p = np.arange(width * height)
    pj, pi = p // width, p % width
    ptile = (pj // tile_h) * tx + (pi // tile_w)
    pwithin = (pj % tile_h) * tile_w + (pi % tile_w)
    inv_real = (ptile * (tile_w * tile_h) + pwithin).astype(np.int32)
    return perm, inv_real, n_slots


def superblock_bounds(block_lo: jnp.ndarray, block_hi: jnp.ndarray,
                      group: int):
    """Union AABBs of `group` consecutive blocks (Morton order makes
    consecutive blocks spatially coherent, so the unions are tight).
    Tail padding uses inverted (+inf, -inf) boxes, which never pass the
    slab test. Computed on the fly from the (possibly per-frame shifted)
    block AABBs, so the dynamic-diff path stays exact."""
    nb = block_lo.shape[0]
    nsb = -(-nb // group)
    pad = nsb * group - nb
    if pad:
        block_lo = jnp.concatenate(
            [block_lo, jnp.full((pad, 3), INF, block_lo.dtype)])
        block_hi = jnp.concatenate(
            [block_hi, jnp.full((pad, 3), -INF, block_hi.dtype)])
    sb_lo = block_lo.reshape(nsb, group, 3).min(axis=1)
    sb_hi = block_hi.reshape(nsb, group, 3).max(axis=1)
    return sb_lo, sb_hi


def _mask_rows(o_lo, o_hi, d_lo, d_hi, t_hi, blo, bhi):
    """block_mask_with_entry's slab math for PAIRED rows: tile hulls
    (W, 3) against per-row block groups (W, G, 3) -> (W, G) mask + entry.
    (The flat version broadcasts all tiles x all blocks; this one tests
    each work item's tile against only its group's member blocks.)"""
    a = blo - o_hi[:, None, :]                        # (W, G, 3)
    b = bhi - o_lo[:, None, :]
    dl = d_lo[:, None, :]
    dh = d_hi[:, None, :]
    straddle = (dl <= 0.0) & (dh >= 0.0)
    q1 = a / jnp.where(dl == 0.0, 1.0, dl)
    q2 = a / jnp.where(dh == 0.0, 1.0, dh)
    q3 = b / jnp.where(dl == 0.0, 1.0, dl)
    q4 = b / jnp.where(dh == 0.0, 1.0, dh)
    t_lo_axis = jnp.minimum(jnp.minimum(q1, q2), jnp.minimum(q3, q4))
    t_hi_axis = jnp.maximum(jnp.maximum(q1, q2), jnp.maximum(q3, q4))
    t_lo_axis = jnp.where(straddle, -INF, t_lo_axis)
    t_hi_axis = jnp.where(straddle, INF, t_hi_axis)
    enter = jnp.maximum(t_lo_axis.max(axis=2), 0.0)
    exit_ = jnp.minimum(t_hi_axis.min(axis=2), t_hi[:, None])
    # Same inverted-padding rejection as block_mask_with_entry: the last
    # superblock's nonexistent members carry (+inf, -inf) boxes that the
    # quotient math alone would PASS.
    valid = (blo <= bhi).all(axis=2)
    return (enter <= exit_) & valid, enter


class WorkList(NamedTuple):
    tile_ids: jnp.ndarray    # (W,) int32, sorted ascending
    block_ids: jnp.ndarray   # (W,) int32
    entry: jnp.ndarray       # (W,) float32 conservative block entry distance
    count: jnp.ndarray       # () int32 number of real entries (rest repeat the last)


def coarse_mask(ti: TileIntervals, block_lo: jnp.ndarray,
                block_hi: jnp.ndarray, group: int):
    """Level-1 cull: (nTiles, nSB) mask + entry against superblock AABBs.

    The flat (nTiles, nBlocks) mask is O(tiles x blocks) interval math plus
    an O(tiles x blocks) argsort per compaction — at 49K blocks (5.2M tris)
    that work dominated the whole frame (measured 611 ms at config 5, most
    of it mask + sort). Grouping `group` consecutive Morton blocks into a
    superblock makes level 1 `group`x smaller; fine_worklist then tests
    only the survivors' member blocks."""
    sb_lo, sb_hi = superblock_bounds(block_lo, block_hi, group)
    m, e = block_mask_with_entry(ti, sb_lo, sb_hi)
    return m, e, m.sum()


def expand_worklist(ti: TileIntervals, wl1: WorkList,
                    member_lo: jnp.ndarray, member_hi: jnp.ndarray,
                    group: int, w_pad: Optional[int]):
    """Expand a compacted (tile, parent-id) work list one level down:
    test each item's `group` member boxes (taken from member_lo/hi, the
    CHILD level's AABBs) and compact the survivors into member ids.

    Returns (WorkList, count). With w_pad=None only the count is needed
    (the sizing pass): the compaction is skipped and WorkList is None.
    The result preserves the parent order (tile-major, approximately
    front-to-back; each item still carries its exact member entry for the
    kernels' early-exit bound)."""
    nm = member_lo.shape[0]
    nparent = -(-nm // group)
    pad = nparent * group - nm
    if pad:
        member_lo = jnp.concatenate(
            [member_lo, jnp.full((pad, 3), INF, member_lo.dtype)])
        member_hi = jnp.concatenate(
            [member_hi, jnp.full((pad, 3), -INF, member_hi.dtype)])
    blo_g = member_lo.reshape(nparent, group, 3)[wl1.block_ids]  # (W1, G, 3)
    bhi_g = member_hi.reshape(nparent, group, 3)[wl1.block_ids]
    t = wl1.tile_ids
    w1_pad = wl1.tile_ids.shape[0]
    mask2, entry2 = _mask_rows(ti.o_lo[t], ti.o_hi[t], ti.d_lo[t],
                               ti.d_hi[t], ti.t_hi[t], blo_g, bhi_g)
    # Parent padding slots replay the last real item; gate their member
    # cells off so the expanded list carries no duplicates.
    slot = jnp.arange(w1_pad, dtype=jnp.int32)
    mask2 = mask2 & (slot < wl1.count)[:, None]
    flat = mask2.reshape(-1)
    count2 = flat.sum().astype(jnp.int32)
    if w_pad is None:
        return None, count2
    # Compact preserving the parent order: position is the sort key, so
    # tile-major + front-to-back survive the expansion.
    pos = jnp.arange(w1_pad * group, dtype=jnp.int32)
    key = jnp.where(flat, pos, jnp.int32(2 ** 31 - 1))
    order = jnp.argsort(key).astype(jnp.int32)
    if w_pad <= order.size:
        order = order[:w_pad]
    else:
        order = jnp.concatenate(
            [order, jnp.zeros((w_pad - order.size,), jnp.int32)])
    last = order[jnp.maximum(count2 - 1, 0)]
    s = jnp.arange(w_pad, dtype=jnp.int32)
    cell = jnp.where(s < count2, order, last)
    item, j = cell // group, cell % group
    # Defensive clamp: an out-of-range member id means out-of-bounds reads
    # in the traversal kernel (a device fault, not an exception). The mask
    # fix above keeps phantom members out of `count2`; the clamp guarantees
    # that even a future masking bug degrades to redundant work on a real
    # member (idempotent for both nearest and any-hit folds), never a fault.
    wl = WorkList(tile_ids=wl1.tile_ids[item],
                  block_ids=jnp.minimum(wl1.block_ids[item] * group + j,
                                        nm - 1),
                  entry=entry2.reshape(-1)[cell],
                  count=count2)
    return wl, count2


def fine_worklist(ti: TileIntervals, mask1: jnp.ndarray, entry1: jnp.ndarray,
                  count1, block_lo: jnp.ndarray, block_hi: jnp.ndarray,
                  group: int, w1_pad: int, w_pad: Optional[int]):
    """Level-2 cull: compact the (tile, superblock) mask and expand the
    survivors into per-member-block tests (expand_worklist). Returns
    (WorkList, count2); WorkList is None when w_pad is None (sizing)."""
    wl1 = compact_worklist(mask1, w1_pad, entry=entry1, count=count1)
    return expand_worklist(ti, wl1, block_lo, block_hi, group, w_pad)


def level_bounds(block_lo: jnp.ndarray, block_hi: jnp.ndarray,
                 groups: tuple):
    """AABBs of every hierarchy level, finest first.

    groups[k] unions level-k boxes into level-(k+1) boxes; returns
    [(block_lo, block_hi), (sb_lo, sb_hi), ..., coarsest]. Computed on the
    fly from the (possibly per-frame shifted) leaf AABBs, so the dynamic-
    diff path stays exact at every level."""
    out = [(block_lo, block_hi)]
    lo, hi = block_lo, block_hi
    for g in groups:
        lo, hi = superblock_bounds(lo, hi, g)
        out.append((lo, hi))
    return out


def multilevel_mask(ti: TileIntervals, block_lo: jnp.ndarray,
                    block_hi: jnp.ndarray, groups: tuple):
    """Top-level cull: (nTiles, n_coarsest) mask + entry vs the COARSEST
    level of `groups`. groups=(g,) reproduces coarse_mask; (g, g) adds a
    super-superblock level — at 49K leaf blocks (config 5) the flat
    (tiles x superblocks) mask and its compaction argsort were ~20% of the
    frame, and each extra level shrinks both by ~group x."""
    lo, hi = level_bounds(block_lo, block_hi, groups)[-1]
    m, e = block_mask_with_entry(ti, lo, hi)
    return m, e, m.sum()


def multilevel_worklist(ti: TileIntervals, mask: jnp.ndarray,
                        entry: jnp.ndarray, count, block_lo: jnp.ndarray,
                        block_hi: jnp.ndarray, groups: tuple, pads: tuple):
    """Compact the coarsest mask and expand level by level down to leaf
    blocks (the R-tree descent as array programs).

    pads[0] sizes the top compaction; pads[k] sizes the k-th expansion.
    A missing/None pad stops the walk (the sizing passes measure one level
    per host sync). Returns (leaf WorkList or None, counts) where counts
    holds every expansion's survivor count, coarsest-to-finest — callers
    record them so frozen buckets can be verified per level."""
    bounds = level_bounds(block_lo, block_hi, groups)
    wl = compact_worklist(mask, pads[0], entry=entry, count=count)
    counts = []
    for i, k in enumerate(range(len(groups) - 1, -1, -1)):
        pad = pads[i + 1] if i + 1 < len(pads) else None
        lo, hi = bounds[k]
        wl, c = expand_worklist(ti, wl, lo, hi, groups[k], pad)
        counts.append(c)
        if wl is None:
            break
    return wl, tuple(counts)


def visited_tiles(wl: WorkList, n_tiles: int) -> jnp.ndarray:
    """(n_tiles,) bool: the ray tiles that appear in the work list,
    INCLUDING padding replays. (The coarse mask is NOT a safe proxy: a tile
    can pass level 1 and lose every member at level 2.)"""
    return jnp.zeros((n_tiles,), bool).at[wl.tile_ids].set(True)


def compact_worklist(mask: jnp.ndarray, w_pad: int,
                     entry: Optional[jnp.ndarray] = None,
                     count=None) -> WorkList:
    """Flatten the (nTiles, NB) mask into a tile-major work list of length
    w_pad. Within each tile, blocks are ordered front-to-back by `entry`
    (when given). Entries past `count` repeat the last real entry (the
    traversal's min/max folds are idempotent, so replays are harmless).
    `count` may pass a precomputed mask.sum() to skip the reduction."""
    nt, nb = mask.shape
    flat = mask.reshape(-1)
    if count is None:
        count = flat.sum().astype(jnp.int32)
    else:
        count = count.astype(jnp.int32)
    if entry is None:
        # Stable argsort of (!mask) puts kept cells first in tile-major
        # order — tile_ids ascend, so each tile's items form one run
        # (bsr_trace.tile_offsets).
        order = jnp.argsort(~flat, stable=True).astype(jnp.int32)
        entry_flat = jnp.zeros_like(flat, jnp.float32)
    else:
        entry_flat = entry.reshape(-1)
        # Single int32 composite key (one sort instead of a multi-key
        # lexsort): [dropped? MAX : tile*4096 + entry quantized to
        # 12 bits]. Quantizing only coarsens the front-to-back order, never
        # correctness.
        finite = jnp.where(jnp.isfinite(entry_flat) & flat, entry_flat, 0.0)
        scale = 4095.0 / jnp.maximum(finite.max(), 1e-6)
        q = jnp.clip(entry_flat * scale, 0.0, 4095.0).astype(jnp.int32)
        tile_key = jnp.arange(nt * nb, dtype=jnp.int32) // nb
        key = jnp.where(flat, tile_key * 4096 + q, jnp.int32(2**31 - 1))
        order = jnp.argsort(key).astype(jnp.int32)
    if w_pad <= order.size:
        order = order[:w_pad]
    else:  # tiny scenes: fewer cells than the minimum bucket
        order = jnp.concatenate(
            [order, jnp.zeros((w_pad - order.size,), jnp.int32)])
    # Repeat the last real entry for padding slots.
    last = order[jnp.maximum(count - 1, 0)]
    slot = jnp.arange(w_pad, dtype=jnp.int32)
    cell = jnp.where(slot < count, order, last)
    return WorkList(tile_ids=cell // nb, block_ids=cell % nb,
                    entry=entry_flat[cell], count=count)
