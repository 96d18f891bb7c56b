"""Block BVH: the array-layout replacement for the reference's R-trees.

The reference prunes ray-triangle work with two levels of R-trees
(environment.go:183 scene tree over objects; mesh.go:139 per-mesh face tree),
traversed per ray with pointer chasing — branchy and scalar, the opposite of
what a vector accelerator wants. Here the acceleration structure is
*array layout*:

  1. triangles are sorted by the Morton code of their centroid (spatial
     locality -> consecutive triangles are spatially close),
  2. consecutive runs of `block_size` triangles form leaf blocks,
  3. each block gets an AABB.

Traversal becomes block-sparse dense algebra: a conservative ray-tile vs
block-AABB mask (ops/cull.py) selects which (ray-tile, tri-block) pairs run
the dense intersection kernel (ops/pallas/bsr_trace.py) — the BSR/SpMV
pattern from BASELINE.json. No pointers, no stack, no divergence.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np

from distributed_raytracer.models.scene import SceneArrays


class BlockBVH(NamedTuple):
    """Per-leaf-block bounds over a Morton-ordered SceneArrays."""

    block_lo: np.ndarray   # (NB, 3) float32 AABB minima
    block_hi: np.ndarray   # (NB, 3) float32 AABB maxima
    block_size: int        # triangles per block (static)

    @property
    def num_blocks(self) -> int:
        return self.block_lo.shape[0]


def morton_codes(points: np.ndarray, bits: int = 21) -> np.ndarray:
    """64-bit Morton codes of 3D points normalized to the scene AABB."""
    lo = points.min(axis=0)
    extent = points.max(axis=0) - lo
    extent = np.where(extent > 0, extent, 1.0)
    q = ((points - lo) / extent * ((1 << bits) - 1)).astype(np.uint64)

    def spread(x: np.ndarray) -> np.ndarray:
        # Interleave bits with two zero gaps (masks for 21-bit inputs).
        x &= np.uint64(0x1FFFFF)
        x = (x | (x << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
        x = (x | (x << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
        x = (x | (x << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
        x = (x | (x << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
        x = (x | (x << np.uint64(2))) & np.uint64(0x1249249249249249)
        return x

    return (spread(q[:, 0]) << np.uint64(2)) | (spread(q[:, 1]) << np.uint64(1)) | spread(q[:, 2])


def morton_order(p0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
                 n_real: int) -> np.ndarray:
    """Permutation sorting the first n_real triangles by centroid Morton code
    (padding triangles stay at the end). Uses the C++ sorter when available
    (bit-identical codes and stable order; models/native.py)."""
    centroids = p0[:n_real] + (e1[:n_real] + e2[:n_real]) / 3.0

    from distributed_raytracer.models import native

    order = native.morton_argsort(centroids) if native.available() else None
    if order is None:
        order = np.argsort(morton_codes(centroids), kind="stable")
    return np.concatenate([order, np.arange(n_real, p0.shape[0])])


def build_block_bvh(arrays: SceneArrays, n_real,
                    block_size: int = 128) -> BlockBVH:
    """Per-block AABBs over (already Morton-ordered) triangle arrays.

    Padding triangles are ignored for bounds; a block that is entirely
    padding gets an inverted AABB that no ray can hit. `n_real` is either
    the count of leading real triangles (tail padding) or a (T,) bool mask
    (interleaved padding from the Morton-gap block alignment). Triangle
    AABB extents get the reference's 1e-4 floor (shared/state/util.go:7) so
    axis-aligned slivers remain hittable by the slab test.
    """
    t_pad = arrays.p0.shape[0]
    assert t_pad % block_size == 0, (t_pad, block_size)
    p0 = np.asarray(arrays.p0, np.float64)
    p1 = p0 + np.asarray(arrays.e1, np.float64)
    p2 = p0 + np.asarray(arrays.e2, np.float64)

    tri_lo = np.minimum(np.minimum(p0, p1), p2)
    tri_hi = np.maximum(np.maximum(p0, p1), p2)
    # bound_epsilon floor per dimension (util.go:7, mesh.go:44).
    center = (tri_lo + tri_hi) / 2
    tri_lo = np.minimum(tri_lo, center - 5e-5)
    tri_hi = np.maximum(tri_hi, center + 5e-5)

    valid = (np.asarray(n_real, bool) if np.ndim(n_real)
             else np.arange(t_pad) < n_real)
    tri_lo = np.where(valid[:, None], tri_lo, np.inf)
    tri_hi = np.where(valid[:, None], tri_hi, -np.inf)

    nb = t_pad // block_size
    block_lo = tri_lo.reshape(nb, block_size, 3).min(axis=1)
    block_hi = tri_hi.reshape(nb, block_size, 3).max(axis=1)
    return BlockBVH(block_lo=block_lo.astype(np.float32),
                    block_hi=block_hi.astype(np.float32),
                    block_size=block_size)


def gap_aligned_slots(codes_sorted: np.ndarray, block_size: int,
                      max_overhead: float = 0.35) -> np.ndarray:
    """Slot map aligning leaf-block boundaries to Morton-code gaps.

    Fixed 128-triangle runs straddle spatially distant clusters (e.g.
    consecutive mesh instances), producing huge block AABBs that every
    nearby ray tile retains. This groups the sorted triangles by their top
    Morton bits and pads each group to a block_size multiple, so no block
    spans a group boundary. The grouping level is chosen adaptively: the
    finest top-bit prefix whose padding overhead stays under
    `max_overhead`. Returns slots (T',) int64 with -1 = padding slot
    (T' a block_size multiple); slots[i] >= 0 indexes the sorted triangle
    order. Level 0 degenerates to the old contiguous layout.
    """
    n = codes_sorted.shape[0]

    def pad(sz):
        return -(-sz // block_size) * block_size

    # Recursive refinement: split a [lo, hi) run at the next Morton level
    # whenever the extra padding it costs fits in the (recursively shared)
    # budget. Deeper levels only ever refine shallower ones, so stopping at
    # the first unaffordable split is safe.
    leaves = []

    def split(lo, hi, level, budget):
        size = hi - lo
        if size <= block_size or level >= 21:
            leaves.append((lo, hi))
            return
        shift = np.uint64(3 * (20 - level))
        prefix = codes_sorted[lo:hi] >> shift
        cuts = lo + np.flatnonzero(prefix[1:] != prefix[:-1]) + 1
        bounds = np.concatenate([[lo], cuts, [hi]])
        sizes = np.diff(bounds)
        cost = int(sum(pad(s) for s in sizes) - pad(size))
        if len(sizes) == 1:                    # no gap at this level
            split(lo, hi, level + 1, budget)
            return
        if cost > budget:
            leaves.append((lo, hi))
            return
        rem = budget - cost
        for a, b in zip(bounds[:-1], bounds[1:]):
            share = rem * (b - a) // size
            split(int(a), int(b), level + 1, share)

    split(0, n, 0, int(n * max_overhead))

    total = sum(pad(b - a) for a, b in leaves)
    slots = np.full(total, -1, np.int64)
    o = 0
    for a, b in leaves:
        slots[o:o + (b - a)] = np.arange(a, b)
        o += pad(b - a)
    return slots


def reorder_scene(arrays: SceneArrays, order: np.ndarray) -> SceneArrays:
    """Apply a triangle slot map to every per-triangle field.

    Entries of -1 become all-zero padding triangles (degenerate: den = 0 and
    num = 0 make every intersection test NaN-false in the kernels)."""
    per_tri = {"p0", "e1", "e2", "geo_n", "plane_d", "k_u", "k_v",
               "c_u", "c_v", "n0", "n1", "n2", "mat_id"}
    pad = order < 0

    def take(name):
        a = np.asarray(getattr(arrays, name))
        out = a[np.maximum(order, 0)]
        out[pad] = 0
        return out

    return arrays._replace(**{name: take(name) for name in per_tri})
