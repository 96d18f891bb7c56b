"""Block-sparse (BVH-culled) frame rendering.

The large-scene path: the dense sweep in ops/render.py does rays x ALL
triangles; this pipeline first culls (ray-tile, tri-block) pairs with the
conservative interval test (ops/cull.py) over the Morton block BVH
(models/bvh.py), then runs only surviving pairs through the block-sparse
traversal (ops/pallas/bsr_trace.py). Images are exact (culling is
conservative); only the work changes — the array-program equivalent of the
reference's two-level R-tree pruning (tracer.go:32, object.go:76).

Rays are laid out in 2D screen tiles (cull.tiled_ray_order): compact tiles
have tight interval hulls, which is what makes the cull effective (2-3%
retention on the 62K-tri benchmark vs ~50% with row strips).

Data layout is row-native end to end: rays are (8, R) packed rows, per-ray
vectors (3, R) rows, shadow queries kernel-ready (L, 8, R). (R, 3) arrays
use 3 of 128 lanes per vector register and forced XLA into layout-copy
thrash + transposing fusions that dominated the frame profile; the rows
form removed ~40% of frame time. Frame assembly is a reshape/transpose
(tile-major -> row-major), not a gather.

The frame is computed in three jitted stages with two tiny host syncs that
size the work lists (power-of-two buckets, so recompiles are rare):
  stage A: primary rays + primary cull mask -> count
  stage B: BSR nearest hit + shadow queries + per-light cull masks -> counts
  stage C: per-light BSR any-hit + Phong accumulation -> frame
freeze()/render_fast() fuse all three into one dispatch with fixed buckets.

Implementation note: every big array (scene, packed triangles, block AABBs,
ray permutations) is passed as a jit *argument*, never closed over — jit
embeds closures as compile-time constants, which blew compile times from
seconds to minutes at 62K triangles.
"""

from __future__ import annotations

import functools
import logging
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

_log = logging.getLogger(__name__)

from distributed_raytracer.models.camera import Camera, CameraArrays
from distributed_raytracer.models.scene import Scene, SceneArrays
from distributed_raytracer.ops import cull, intersect, raygen, shade
from distributed_raytracer.ops.pallas import bsr_trace
from distributed_raytracer.utils.config import RenderConfig, DEFAULT_CONFIG


def _next_pow2(n: int) -> int:
    return 1 << max(8, int(n - 1).bit_length())


# Work-list capacity rounding: 2048-granular (see bsr_trace.bucket_w_pad) —
# pow2 rounding wasted up to 2x of every kernel launch.
_bucket = bsr_trace.bucket_w_pad


def _tile_bucket(n: int, n_tiles: int) -> int:
    """Capacity for the compacted hit-TILE set: pow2, floor 8, capped at
    the full tile count (cap = no compaction, overflow impossible)."""
    return min(n_tiles, max(8, 1 << max(0, int(n - 1).bit_length())))


def _slim_arrays(arrays: SceneArrays) -> SceneArrays:
    """Strip the per-triangle fields the culled pipeline never reads before
    the device transfer. Only shapes survive ((T, 0) placeholders keep
    `p0.shape[0]` meaningful for id clamping); lights and material tables
    stay real. The full host copy lives on as `renderer.arrays_host`."""
    t = arrays.p0.shape[0]
    e2 = np.zeros((t, 0), np.float32)
    e1 = np.zeros((0,), np.float32)
    return arrays._replace(
        p0=e2, e1=e2, e2=e2, geo_n=e2, n0=e2, n1=e2, n2=e2,
        k_u=e2, k_v=e2, plane_d=e1, c_u=e1, c_v=e1,
        mat_id=np.zeros((0,), np.int32))


class CulledRenderer:
    """Per-(scene, resolution) renderer instance with cached jit stages."""

    def __init__(self, scene: Optional[Scene], width: int, height: int,
                 cfg: RenderConfig = DEFAULT_CONFIG,
                 block_size=128, ray_tile: int = 512, prebaked=None,
                 cull_group: int = 16, tile_w: Optional[int] = None,
                 cull_levels: Optional[int] = None):
        if block_size == "auto":
            # Measured per-scene leaf-size policy (config.default_block_size).
            from distributed_raytracer.utils.config import (
                default_block_size)
            block_size = default_block_size(
                scene.num_tris if scene is not None else 1 << 30)
        self.width, self.height, self.cfg = width, height, cfg
        self.rt, self.tb = ray_tile, block_size
        # Hierarchical cull: `cull_group` consecutive Morton blocks form a
        # superblock; above ~768 superblocks a SECOND grouping level
        # (super-superblocks) is added (cull.multilevel_mask/worklist) —
        # at 49K blocks (config 5) the flat mask + its argsort dominated
        # the frame, and each level shrinks both by ~group x. `groups` is
        # set after the bake (it depends on the block count).
        self.cull_group = cull_group
        # Full-frame height for ray projection; the multi-chip band renderer
        # overrides this so each band's global pixel indices project with
        # the whole frame's field of view (parallel/render_sharded_bvh.py).
        self.raygen_height = height

        # `prebaked` = (SceneArrays, BlockBVH) from a cached bake_bvh — the
        # multi-million-triangle configs take minutes to bake, so bench and
        # services cache the bundle on disk (bench.py config 5).
        if prebaked is not None:
            arrays, tree = prebaked
            # The bundle's leaf size is baked in; the block_size argument
            # cannot re-block a prebaked tree, so derive from it.
            self.tb = block_size = int(tree.block_size)
        else:
            arrays, tree = self._bake_scene(scene, block_size)
        # Packing happens on the HOST and only the packed forms ship:
        # the traversal consumes tris_packed + shade_tbl + block AABBs,
        # never the raw per-triangle fields.
        self.arrays_host: SceneArrays = arrays
        self.tree = tree   # kept for cheap re-instantiation via prebaked=
        tris16_np = bsr_trace.pack_tris(arrays)
        self.arrays: SceneArrays = jax.device_put(_slim_arrays(arrays))
        # Ship only the 12 REAL triangle columns and pad back to 16 on
        # device (cols 12:16 are zeros by construction).
        self.tris_packed = jnp.pad(
            jax.device_put(np.ascontiguousarray(tris16_np[:, :12])),
            ((0, 0), (0, 4)))
        # Shading table assembled ON DEVICE (shade.table_rows_device):
        # only p0, the vertex normals (smooth bakes), and mat_id cross the
        # host link; k_u/k_v/geo_n are already on device inside
        # tris_packed and materials gather from the tiny tables. Stored
        # TRANSPOSED (32, T): shading gathers along the lane axis
        # (shade.prepare_packed), avoiding a (C, 32) intermediate + layout
        # copy per frame.
        flat_bake = (np.array_equal(arrays.n0, arrays.geo_n)
                     and np.array_equal(arrays.n1, arrays.geo_n)
                     and np.array_equal(arrays.n2, arrays.geo_n))
        p0_t = jax.device_put(np.ascontiguousarray(
            np.asarray(arrays.p0, np.float32).T))
        n_t = None if flat_bake else jax.device_put(np.ascontiguousarray(
            np.concatenate([np.asarray(arrays.n0, np.float32).T,
                            np.asarray(arrays.n1, np.float32).T,
                            np.asarray(arrays.n2, np.float32).T])))
        mat_id_dev = jax.device_put(np.asarray(arrays.mat_id, np.int32))
        self.shade_tbl = shade.table_rows_device(
            self.tris_packed, p0_t, n_t, mat_id_dev, self.arrays.mat_ka,
            self.arrays.mat_kd, self.arrays.mat_ks, self.arrays.mat_ns)
        self.block_lo = jnp.asarray(tree.block_lo)
        self.block_hi = jnp.asarray(tree.block_hi)
        # Hierarchy depth: one grouping level normally; two when the
        # superblock count itself is large enough that the top mask +
        # compaction argsort would dominate (threshold in superblocks).
        # `cull_levels` (2 or 3) overrides the auto choice (tests exercise
        # the 3-level walk on small scenes; A/B measurement).
        nsb = -(-tree.num_blocks // cull_group)
        if cull_levels is None:
            cull_levels = 3 if nsb > 768 else 2
        self.groups = (cull_group,) * (cull_levels - 1)
        # Count-vector layout: per-level primary counts (top mask count +
        # one per expansion), the hit-tile count, then the shadow counts
        # in the same level layout. For groups=(g,) this is exactly the
        # historical (c1, c2, ht, sc1, sc2).
        self.n_levels = len(self.groups) + 1
        self._ht_idx = self.n_levels              # index of ht in counts
        # Shared-origin shadow columns: per-light origin-folded (T, 16)
        # packs stacked to (L*T, 16) — block_ids with the light*nb offset
        # index straight into light l's rows.
        self.lights_scal = bsr_trace.lights_origin_packs(
            self.tris_packed, self.arrays.light_pos)

        # 2D screen tiles (default 32 x rt/32 pixels): see module
        # docstring. `tile_w` overrides the aspect — squarer tiles have
        # tighter interval hulls per ray (less angular spread), which can
        # cut scheduled pairs on surface-heavy scenes at the cost of more
        # tiles.
        self.tile_w = 32 if tile_w is None else tile_w
        self.tile_h = ray_tile // self.tile_w
        perm, inv_real, n_slots = cull.tiled_ray_order(
            width, height, self.tile_w, self.tile_h)
        self._perm = jax.device_put(jnp.asarray(perm))
        self._inv_real = jax.device_put(jnp.asarray(inv_real))
        self.n_pad = n_slots
        self.n_tiles = self.n_pad // ray_tile

        self._stage_a = jax.jit(self._stage_a_fn)
        # Per-ray live mask for partial-frame renders (None = all live).
        # The cost-balanced band renderer sets this to kill padding tiles.
        self._live = None
        self._stage_b_cache = {}
        self._stage_c_cache = {}
        self._count_fine_cache = {}
        self._fused = None          # frozen-bucket fast path
        # (c1, c2, sc1, sc2) from the last sync render: coarse/fine primary
        # cells, coarse/fine shadow cells.
        self._last_counts = None

    def _bake_scene(self, scene: Scene, block_size: int):
        """Bake hook: the dynamic renderer (ops/render_dynamic.py) overrides
        this to group leaf blocks per object for exact AABB shifts."""
        return scene.bake_bvh(block_size=block_size)

    # -- frame assembly ---------------------------------------------------

    def _assemble(self, rows: jnp.ndarray) -> jnp.ndarray:
        """(3, n_pad) tile-major colour rows -> (H, W, 3) row-major frame.

        Pure reshape/transpose (slot s = ((tj*tx + ti)*th + wj)*tw + wi, the
        cull.tiled_ray_order layout) — replaces the (R, 3) inv_real gather,
        which cost more than the intersection kernels.
        """
        tw, th = self.tile_w, self.tile_h
        tx, ty = -(-self.width // tw), -(-self.height // th)
        img = rows.reshape(3, ty, tx, th, tw).transpose(1, 3, 2, 4, 0)
        img = img.reshape(ty * th, tx * tw, 3)
        return img[:self.height, :self.width]

    # -- stage A: primary rays + cull ------------------------------------

    def _stage_a_fn(self, cam: CameraArrays, perm, block_lo, block_hi,
                    live=None):
        """`live` ((n_pad,) bool or None) masks rays out of the tile
        interval hulls — the cost-balanced band renderer marks its padding
        tiles dead so they cull to zero work (parallel/render_sharded_bvh
        balanced mode); full-frame renders pass None."""
        d_rows = raygen.ray_rows_flat(cam, self.width, self.raygen_height,
                                      perm)
        rays = bsr_trace.pack_rays_rows(cam.pos, d_rows)
        ti = cull.tile_intervals_packed(rays, self.rt, live=live)
        mask1, entry1, c1 = cull.multilevel_mask(ti, block_lo, block_hi,
                                                 self.groups)
        return rays, ti, mask1, entry1, c1

    def _count_next(self, pads: tuple):
        """Jitted next-level survivor counter for the sizing renders
        (shared by the primary and shadow masks — retraces per shape).
        `pads` holds the already-sized buckets; the return is the count of
        the FIRST unsized level below them."""
        key = ("count", pads)
        fn = self._count_fine_cache.get(key)
        if fn is None:
            def count_fn(block_lo, block_hi, ti, mask1, entry1, c1):
                m = mask1.reshape(-1, mask1.shape[-1])
                e = entry1.reshape(-1, entry1.shape[-1])
                _, counts = cull.multilevel_worklist(
                    ti, m, e, c1, block_lo, block_hi, self.groups, pads)
                return counts[-1]
            fn = jax.jit(count_fn)
            self._count_fine_cache[key] = fn
        return fn

    def _size_pads(self, ti, mask, entry, c_top, block_lo, block_hi):
        """Walk the hierarchy with one host sync per level: returns
        (pads tuple len n_levels, counts tuple len n_levels)."""
        counts = [int(c_top)]
        pads = [_bucket(counts[0])]
        for _ in range(len(self.groups)):
            c = self._count_next(tuple(pads))(block_lo, block_hi, ti, mask,
                                              entry, c_top)
            counts.append(int(c))
            pads.append(_bucket(counts[-1]))
        return tuple(pads), tuple(counts)

    def per_tile_cells(self, camera) -> np.ndarray:
        """(n_tiles,) int32: fine-level cull cells per ray tile for this
        camera — the per-tile WORK signal. The cost-balanced band partition
        (parallel/render_sharded_bvh, the least-loaded-scheduler analog of
        master/pool/pool.go:148-197) sums these per tile row to size band
        heights so every device schedules ~equal pairs. Sizing-time only
        (one host sync per level; the scatter-add is small)."""
        cam = camera.to_arrays() if isinstance(camera, Camera) else camera
        _, ti, mask1, entry1, c1 = self._stage_a(
            cam, self._perm, self.block_lo, self.block_hi, self._live)
        pads, _ = self._size_pads(ti, mask1, entry1, c1,
                                  self.block_lo, self.block_hi)
        key = ("per_tile", pads)
        fn = self._count_fine_cache.get(key)
        if fn is None:
            def per_tile_fn(block_lo, block_hi, ti, mask1, entry1, c1):
                m = mask1.reshape(-1, mask1.shape[-1])
                e = entry1.reshape(-1, entry1.shape[-1])
                wl, _ = cull.multilevel_worklist(
                    ti, m, e, c1, block_lo, block_hi, self.groups, pads)
                real = (jnp.arange(pads[-1], dtype=jnp.int32)
                        < wl.count).astype(jnp.int32)
                return jnp.zeros((self.n_tiles,), jnp.int32
                                 ).at[wl.tile_ids].add(real)
            fn = jax.jit(per_tile_fn)
            self._count_fine_cache[key] = fn
        return np.asarray(fn(self.block_lo, self.block_hi, ti, mask1,
                             entry1, c1))

    # -- stage B: nearest hit + shadow masks -----------------------------

    def _nearest(self, pads, scene, tris_packed, rays, exclude,
                 block_lo, block_hi, ti, mask1, entry1, c1,
                 shared_origin=False):
        """Multi-level compaction + BSR nearest. Returns (Hits, expansion
        counts tuple). Ray tiles absent from the work list keep the miss
        init (the cull proved no block can be hit)."""
        wl, counts = cull.multilevel_worklist(ti, mask1, entry1, c1,
                                              block_lo, block_hi,
                                              self.groups, pads)
        best_t, best_i = bsr_trace.bsr_nearest(
            rays, exclude, tris_packed, wl.tile_ids, wl.block_ids,
            wl.count, rt=self.rt, tb=self.tb,
            shared_origin=shared_origin)
        hits = intersect.Hits(t=best_t,
                              tri=jnp.minimum(best_i, scene.p0.shape[0] - 1),
                              valid=jnp.isfinite(best_t))
        return hits, counts

    def _light_masks(self, prep, live_l, block_lo, block_hi):
        """Per-light coarse cull masks for the shadow queries, plus the
        stacked (L*nTiles) tile hulls the fine stage tests against. Dead
        rays (misses, and rays this light provably cannot colour —
        shade.light_gates) are masked out of the tile hulls
        (cull.tile_intervals_packed live=) so they never widen the work
        lists."""
        n_lights = prep.q.shape[0]
        nt = prep.q_rev.shape[2] // self.rt if n_lights else 0
        tis, smasks, sentries = [], [], []
        for li in range(n_lights):
            ti = cull.tile_intervals_packed(prep.q_rev[li], self.rt,
                                            live=live_l[li], use_tmax=True)
            m, e, _ = cull.multilevel_mask(ti, block_lo, block_hi,
                                           self.groups)
            tis.append(ti)
            smasks.append(m)
            sentries.append(e)
        ntop = block_lo.shape[0]
        for g in self.groups:
            ntop = -(-ntop // g)
        if not n_lights:
            empty_ti = cull.TileIntervals(
                *(jnp.zeros((0, 3), jnp.float32),) * 4,
                t_hi=jnp.zeros((0,), jnp.float32))
            return (empty_ti, jnp.zeros((0, nt, ntop), bool),
                    jnp.zeros((0, nt, ntop), jnp.float32))
        sti = cull.TileIntervals(*(jnp.concatenate(
            [getattr(t, f) for t in tis]) for f in cull.TileIntervals._fields))
        return sti, jnp.stack(smasks), jnp.stack(sentries)

    def _stage_b1_fn(self, pads: tuple, scene: SceneArrays,
                     tris_packed, block_lo, block_hi,
                     rays, ti, mask1, entry1, c1):
        """Primary nearest hit only. Returns (hits, hcount, counts)."""
        no_excl = jnp.full((self.n_pad,), -1, jnp.int32)
        # Primary rays share the camera origin (rays rows 0..2 are a
        # broadcast of cam.pos): fold it into the per-triangle columns each
        # frame and run the shared-origin traversal.
        tris_cam = bsr_trace.pack_tris_origin(tris_packed, rays[0:3, 0])
        hits, counts = self._nearest(pads, scene,
                                     tris_cam, rays, no_excl,
                                     block_lo, block_hi, ti, mask1, entry1,
                                     c1, shared_origin=True)
        n_tiles = hits.valid.shape[0] // self.rt
        ht = hits.valid.reshape(n_tiles, self.rt).any(axis=1).sum()
        return hits, ht.astype(jnp.int32), counts

    def _stage_b2_fn(self, ht_pad: int, scene: SceneArrays, shade_tbl,
                     block_lo, block_hi, rays, hits):
        """Hit-TILE compaction + shading prep + per-light shadow masks.

        Everything downstream of the nearest kernel is proportional to the
        hit count, not the ray count — at 640x480 on the example scene
        only ~8% of rays hit, and the uncompacted prep/fetch/shadow work
        over all rays dominated the frame. Compaction is at RAY-TILE
        granularity: tile-granular gathers move contiguous (8, rt) chunks
        and the index math runs on a few-hundred-element array instead of
        300K-element scatters/searches. Tiles are already the pipeline's
        currency, so spatial coherence is preserved exactly.

        Returns (tpos, hit_tile, hits_h, prep, live_l, sti, smasks,
        sentries, sc1, ht_count); `tpos`/`hit_tile` drive the gather-based
        write-back in stage C. ht_pad is capped at n_tiles by the callers,
        so overflow is impossible when every tile hits.
        """
        (tpos, hit_tile, tidx, ht_count, rays_h,
         hits_h) = self._compact_tiles(ht_pad, rays, hits)
        prep = shade.prepare_packed(scene, rays_h, hits_h, self.cfg,
                                    table=shade_tbl)
        live_l = shade.light_gates(scene, rays[0:3, 0], prep, hits_h.valid)
        sti, smasks, sentries = self._light_masks(prep, live_l,
                                                  block_lo, block_hi)
        return (tpos, hit_tile, hits_h, prep, live_l, sti, smasks,
                sentries, smasks.sum(), ht_count)

    def _compact_tiles(self, ht_pad: int, rays, hits):
        """Order-preserving hit-TILE compaction (see _stage_b2_fn's
        docstring for why tile granularity): returns (tpos, hit_tile,
        tidx, ht_count, rays_h, hits_h) with compacted shapes ht_pad*rt.
        A stable argsort of ~600 bools, never a large scatter/search."""
        nt, rt = self.n_tiles, self.rt
        hit_t = hits.valid.reshape(nt, rt)
        hit_tile = hit_t.any(axis=1)                            # (nt,)
        tidx = jnp.argsort(~hit_tile, stable=True)[:ht_pad].astype(jnp.int32)
        ht_count = hit_tile.sum().astype(jnp.int32)
        tile_ok = jnp.arange(ht_pad, dtype=jnp.int32) < ht_count
        tpos = jnp.cumsum(hit_tile.astype(jnp.int32)) - 1       # (nt,)
        h = ht_pad * rt
        rays_h = rays.reshape(8, nt, rt)[:, tidx, :].reshape(8, h)
        valid_h = (hit_t[tidx] & tile_ok[:, None]).reshape(h)
        t_h = jnp.where(valid_h,
                        hits.t.reshape(nt, rt)[tidx].reshape(h), 0.0)
        tri_h = jnp.where(valid_h,
                          hits.tri.reshape(nt, rt)[tidx].reshape(h), 0)
        return (tpos, hit_tile, tidx, ht_count, rays_h,
                intersect.Hits(t=t_h, tri=tri_h, valid=valid_h))

    def _gather_tiles(self, rows_h, tpos, hit_tile, fill=0.0):
        """Tile-granular write-back: compacted (..., ht_pad*rt) rows ->
        full-grid (..., n_pad); non-hit tiles get `fill`."""
        rt = self.rt
        ht_pad = rows_h.shape[-1] // rt
        src = jnp.clip(tpos, 0, ht_pad - 1)
        if rows_h.ndim == 1:
            out = rows_h.reshape(ht_pad, rt)[src]
            return jnp.where(hit_tile[:, None], out,
                             fill).reshape(self.n_pad)
        out = rows_h.reshape(rows_h.shape[0], ht_pad, rt)[:, src, :]
        return jnp.where(hit_tile[None, :, None], out,
                         fill).reshape(rows_h.shape[0], self.n_pad)

    # -- stage C: shadow queries + shading -------------------------------

    def _shadow_query(self, s_pads: tuple, lights_scal, block_lo, block_hi,
                      prep, hits, live_l, sti, smasks, sentries, sc1):
        """All lights' shadow queries as ONE bsr_any work list: the (light,
        tile) pairs become the tile axis of a single multi-level work list
        (one compaction, one launch, one set of padding slots instead of
        one each per light). Dead rays (per-light: misses + zero-potential-
        contribution, shade.light_gates) pre-seed the result as occluded so
        a sub-block stops as soon as its live rays are.
        Returns (bsr_any positional arguments, shadow expansion counts);
        lights must be non-empty."""
        n_lights = prep.q.shape[0]
        r = prep.q_rev.shape[2]
        n_tiles = r // self.rt
        nb = block_lo.shape[0]
        n_tris = nb * self.tb
        mask = smasks.reshape(n_lights * n_tiles, -1)
        entry = sentries.reshape(n_lights * n_tiles, -1)
        wl, s_counts = cull.multilevel_worklist(sti, mask, entry, sc1,
                                                block_lo, block_hi,
                                                self.groups, s_pads)
        q = prep.q_rev.transpose(1, 0, 2).reshape(8, n_lights * r)
        # Each light's rays share its origin; the per-light origin-folded
        # rows sit at block offset light*nb (row light*T).
        light_of = wl.tile_ids // n_tiles
        block_ids = light_of * nb + wl.block_ids
        excl = (hits.tri[None, :]
                + (jnp.arange(n_lights, dtype=jnp.int32) * n_tris)[:, None]
                ).reshape(-1)
        dead = (~live_l).reshape(-1).astype(jnp.int32)
        return ((q, excl, lights_scal, wl.tile_ids, block_ids, wl.count,
                 dead), s_counts)

    def _lit(self, s_pads: tuple, lights_scal,
             block_lo, block_hi, prep, hits, live_l, sti, smasks, sentries,
             sc1):
        """Returns (lit (L, n_pad) bool, shadow expansion counts)."""
        n_lights = prep.q.shape[0]
        if n_lights == 0:
            return (jnp.zeros((0, self.n_pad), bool),
                    (jnp.int32(0),) * len(self.groups))
        args, s_counts = self._shadow_query(
            s_pads, lights_scal, block_lo, block_hi, prep, hits, live_l, sti,
            smasks, sentries, sc1)
        hit = bsr_trace.bsr_any(*args, rt=self.rt, tb=self.tb,
                                shared_origin=True)
        return hit.reshape(n_lights, -1) == 0, s_counts

    def _stage_c_fn(self, s_pads: tuple, scene: SceneArrays,
                    lights_scal, block_lo, block_hi,
                    cam: CameraArrays, tpos, hit_tile, hits_h, prep, live_l,
                    sti, smasks, sentries, sc1):
        """Shadow queries + Phong on the COMPACTED tile set, written back
        by a tile-granular GATHER: output tile j reads compact tile
        tpos[j] if it had any hit, else black."""
        lit, s_counts = self._lit(s_pads, lights_scal,
                                  block_lo, block_hi, prep, hits_h, live_l,
                                  sti, smasks, sentries, sc1)
        colours_h = shade.shade_core_packed(scene, cam.pos, prep, hits_h,
                                            lit)                 # (3, H)
        rt = self.rt
        ht_pad = colours_h.shape[1] // rt
        src_t = jnp.clip(tpos, 0, ht_pad - 1)
        cols = colours_h.reshape(3, ht_pad, rt)[:, src_t, :]   # (3, nt, rt)
        colours = jnp.where(hit_tile[None, :, None], cols,
                            0.0).reshape(3, self.n_pad)
        return self._assemble(colours), s_counts

    # -- multi-bounce stages ---------------------------------------------
    #
    # Whitted reflections on the block-sparse path (config 2 of
    # BASELINE.json; semantics identical to ops/render.py
    # trace_rays_bounced / the float64 oracle's _radiance). Each bounce is
    # one more BSR nearest query whose ray set is the previous bounce's
    # reflections, plus per-light BSR shadow queries; the radiance
    # accumulates as colour += throughput * phong_b with one final clamp.

    def _reflect_from(self, prep, rays, valid):
        """Reflection rays + liveness from one bounce's shading prep
        (shading normal for both the mirror and the epsilon lift; dead
        rays — miss or zero-Ks — carry live=False and are masked out of
        every downstream tile hull)."""
        cfg = self.cfg
        n = prep.normal
        d = rays[3:6]
        d_dot_n = jnp.sum(d * n, axis=0)
        refl = d - 2.0 * d_dot_n[None, :] * n
        rlen = jnp.sqrt(jnp.sum(refl * refl, axis=0, keepdims=True))
        refl = refl / jnp.where(rlen > 0, rlen, 1.0)
        side = jnp.where(jnp.sum(n * refl, axis=0) >= 0.0, 1.0, -1.0)
        o = (prep.x + cfg.shadow_offset * refl
             + (cfg.shadow_normal_offset * side)[None, :] * n)
        r_rays = bsr_trace.pack_rays_rows(o, refl)
        live = valid & jnp.any(prep.ks > 0.0, axis=0)
        return r_rays, live

    def _stage_bounce_nearest_fn(self, p_pads: tuple, scene: SceneArrays,
                                 tris_packed, block_lo, block_hi, rays,
                                 exclude, ti, mask1, entry1, c1):
        """Per-ray-origin nearest for one bounce's ray set. Returns
        (hits, hit-tile count, per-level counts)."""
        hits, p_counts = self._nearest(p_pads, scene, tris_packed, rays,
                                       exclude, block_lo, block_hi, ti,
                                       mask1, entry1, c1)
        nt = hits.valid.shape[0] // self.rt
        ht = hits.valid.reshape(nt, self.rt).any(axis=1).sum()
        return hits, ht.astype(jnp.int32), p_counts

    def _stage_bounce_prep_fn(self, ht_pad: int, scene: SceneArrays,
                              shade_tbl, block_lo, block_hi, rays, hits,
                              view):
        """Hit-TILE compaction + shading prep + shadow masks + the next
        bounce's reflection query, all on the COMPACTED tile set — the
        bounce-path twin of _stage_b2_fn (everything downstream of the
        nearest kernel is hit-proportional, and at 1080p with ~8% hit
        fraction the uncompacted per-bounce prep dominated config 2).
        `view` is the viewer for the light gates ((3,) camera at bounce 0,
        (3, n_pad) previous hit points after); it is compacted alongside.
        Reflection rays are built compacted and scattered back to the full
        grid (zeros + live=False for non-hit tiles, which cull away)."""
        (tpos, hit_tile, tidx, ht_count, rays_h,
         hits_h) = self._compact_tiles(ht_pad, rays, hits)
        if view.ndim == 1:
            view_h = view
        else:
            h = ht_pad * self.rt
            view_h = view.reshape(3, self.n_tiles,
                                  self.rt)[:, tidx, :].reshape(3, h)
        prep = shade.prepare_packed(scene, rays_h, hits_h, self.cfg,
                                    table=shade_tbl)
        live_l = shade.light_gates(scene, view_h, prep, hits_h.valid)
        sti, smasks, sentries = self._light_masks(prep, live_l,
                                                  block_lo, block_hi)
        r_rays_h, r_live_h = self._reflect_from(prep, rays_h, hits_h.valid)
        r_rays = self._gather_tiles(r_rays_h, tpos, hit_tile)
        r_live = self._gather_tiles(r_live_h, tpos, hit_tile, fill=False)
        r_ti = cull.tile_intervals_packed(r_rays, self.rt, live=r_live)
        r_mask1, r_entry1, r_c1 = cull.multilevel_mask(
            r_ti, block_lo, block_hi, self.groups)
        return (tpos, hit_tile, hits_h, prep, live_l, sti, smasks,
                sentries, smasks.sum(), ht_count, view_h,
                r_rays, r_live, r_ti, r_mask1, r_entry1, r_c1)

    def _stage_shade_fn(self, s_pads: tuple,
                        scene: SceneArrays, lights_scal,
                        block_lo, block_hi, view, hits, prep, live_l, sti,
                        smasks, sentries, sc1):
        """Fused shadow query + phong for one bounce -> ((3, C) local
        radiance rows (not yet throughput-weighted), shadow counts)."""
        lit, s_counts = self._lit(s_pads, lights_scal,
                                  block_lo, block_hi, prep, hits, live_l,
                                  sti, smasks, sentries, sc1)
        return (shade.shade_core_packed(scene, view, prep, hits, lit),
                s_counts)

    def render_bounced(self, camera, depth: int, block: bool = False):
        """Whitted multi-bounce render on the block-sparse path."""
        cam = camera.to_arrays() if isinstance(camera, Camera) else camera
        rays, ti, mask1, entry1, c1 = self._stage_a(
            cam, self._perm, self.block_lo, self.block_hi)

        def jit_for(cache, key, fn, *static):
            f = cache.get(key)
            if f is None:
                f = jax.jit(functools.partial(fn, *static))
                cache[key] = f
            return f

        colour = jnp.zeros((3, self.n_pad), jnp.float32)
        throughput = jnp.ones((3, self.n_pad), jnp.float32)
        view = cam.pos
        exclude = jnp.full((self.n_pad,), -1, jnp.int32)
        pads_used = []
        counts_used = []

        for b in range(depth + 1):
            p_pads, p_counts = self._size_pads(ti, mask1, entry1, c1,
                                               self.block_lo, self.block_hi)
            nf = jit_for(self._stage_b_cache,
                         ("bounceN", p_pads),
                         self._stage_bounce_nearest_fn, p_pads)
            hits, hcount, _ = nf(
                self.arrays, self.tris_packed, self.block_lo, self.block_hi,
                rays, exclude, ti, mask1, entry1, c1)
            ht_pad = _tile_bucket(int(hcount), self.n_tiles)
            pf = jit_for(self._stage_b_cache, ("bounceP", ht_pad),
                         self._stage_bounce_prep_fn, ht_pad)
            (tpos, hit_tile, hits_h, prep, live_l, sti, smasks, sentries,
             sc1, ht_count, view_h, r_rays, r_live, r_ti, r_mask1,
             r_entry1, r_c1) = pf(self.arrays, self.shade_tbl,
                                  self.block_lo, self.block_hi, rays, hits,
                                  view)
            s_pads, s_counts = self._size_pads(sti, smasks, sentries, sc1,
                                               self.block_lo, self.block_hi)
            pads_used.append(p_pads + (ht_pad,) + s_pads)
            counts_used.append(p_counts + (int(ht_count),) + s_counts)
            sc = jit_for(self._stage_c_cache,
                         ("shade", b > 0, s_pads),
                         self._stage_shade_fn, s_pads)
            local_h, _ = sc(self.arrays, self.lights_scal,
                            self.block_lo, self.block_hi, view_h, hits_h,
                            prep, live_l, sti, smasks, sentries, sc1)
            colour = colour + throughput * self._gather_tiles(
                local_h, tpos, hit_tile)
            if b == depth:
                break
            ks_full = self._gather_tiles(prep.ks, tpos, hit_tile)
            throughput = jnp.where(hits.valid[None, :],
                                   throughput * ks_full, 0.0)
            view = self._gather_tiles(prep.x, tpos, hit_tile)
            rays = r_rays
            exclude = hits.tri
            ti, mask1, entry1, c1 = r_ti, r_mask1, r_entry1, int(r_c1)

        colour = jnp.clip(colour, 0.0, 1.0)
        img = self._assemble(colour)
        self._last_bounce_pads = tuple(pads_used)
        # Raw (unbucketed) counts: bucket sizing applies margins to these,
        # never to already-rounded pads (margin-on-rounded over-allocates
        # up to a granule and drifts from the culled path's discipline).
        self._last_bounce_counts = tuple(counts_used)
        if block:
            jax.block_until_ready(img)
        return img

    def _full_bounced_fn(self, pads: tuple, scene: SceneArrays, tris_packed,
                         lights_scal, shade_tbl, block_lo,
                         block_hi, perm, cam: CameraArrays):
        """Fused multi-bounce pipeline with fixed buckets (no host syncs).

        Also returns the true per-bounce work counts as a
        (B, 2*n_levels + 1) int32 array [per-level primary cells, the
        hit-tile count, per-level shadow cells — the same layout as the
        primary path] so callers — including the sharded band renderer —
        can verify the frozen buckets still hold and refreeze on overflow
        instead of silently dropping candidate blocks.
        """
        rays, ti, mask1, entry1, c1 = self._stage_a_fn(cam, perm, block_lo,
                                                       block_hi)
        colour = jnp.zeros((3, self.n_pad), jnp.float32)
        throughput = jnp.ones((3, self.n_pad), jnp.float32)
        view = cam.pos
        exclude = jnp.full((self.n_pad,), -1, jnp.int32)
        counts = []
        nl = self.n_levels
        for b, b_pads in enumerate(pads):
            p_pads, ht_pad, s_pads = b_pads[:nl], b_pads[nl], b_pads[nl + 1:]
            hits, hcount, p_counts = self._stage_bounce_nearest_fn(
                p_pads, scene, tris_packed, block_lo, block_hi, rays,
                exclude, ti, mask1, entry1, c1)
            (tpos, hit_tile, hits_h, prep, live_l, sti, smasks, sentries,
             sc1, ht_count, view_h, r_rays, _, r_ti, r_mask1, r_entry1,
             r_c1) = self._stage_bounce_prep_fn(
                ht_pad, scene, shade_tbl, block_lo, block_hi, rays, hits,
                view)
            local_h, s_counts = self._stage_shade_fn(
                s_pads, scene, lights_scal,
                block_lo, block_hi, view_h, hits_h, prep, live_l, sti,
                smasks, sentries, sc1)
            colour = colour + throughput * self._gather_tiles(
                local_h, tpos, hit_tile)
            counts.append(jnp.stack([c1, *p_counts, ht_count, sc1,
                                     *s_counts]).astype(jnp.int32))
            if b + 1 == len(pads):
                break
            ks_full = self._gather_tiles(prep.ks, tpos, hit_tile)
            throughput = jnp.where(hits.valid[None, :],
                                   throughput * ks_full, 0.0)
            view = self._gather_tiles(prep.x, tpos, hit_tile)
            rays = r_rays
            exclude = hits.tri
            ti, mask1, entry1, c1 = r_ti, r_mask1, r_entry1, r_c1
        colour = jnp.clip(colour, 0.0, 1.0)
        return self._assemble(colour), jnp.stack(counts)

    def freeze_bounced(self, camera, depth: int, margin: float = 1.4):
        """Fuse the multi-bounce pipeline with buckets sized from one sync
        render's RAW counts x margin. Returns the fused render function;
        render(cam, verify=True) blocks to check the true per-bounce counts
        against the buckets and refreezes + rerenders on overflow (the
        multi-bounce analog of render_fast(verify=True))."""
        self.render_bounced(camera, depth, block=True)
        state = {}

        def freeze_from(counts):
            hi = self._ht_idx      # hit-tile slot: its own bucket + cap
            pads = tuple(
                tuple(_tile_bucket(int(x * margin), self.n_tiles)
                      if k == hi else _bucket(x, margin)
                      for k, x in enumerate(quad))
                for quad in counts)
            prev = state.get("pads")
            if prev is not None:   # grow-only, as freeze()
                pads = tuple(tuple(max(p, q) for p, q in zip(quad, pq))
                             for quad, pq in zip(pads, prev))
            state["pads"] = pads
            state["fused"] = jax.jit(functools.partial(
                self._full_bounced_fn, state["pads"]))

        freeze_from(self._last_bounce_counts)

        def render(cam, verify: bool = False):
            c = cam.to_arrays() if isinstance(cam, Camera) else cam
            args = (self.arrays, self.tris_packed,
                    self.lights_scal, self.shade_tbl, self.block_lo,
                    self.block_hi, self._perm, c)
            img, counts = state["fused"](*args)
            if verify:
                # Loop until all per-bounce counts fit: an overflowed
                # level-1 bucket truncates the level-1 list, making the
                # reported level-2 counts undercounts — one refreeze from
                # them is not sufficient (see render_fast's verify loop).
                fits = False
                for _ in range(8):
                    got = np.asarray(counts)
                    if not any(any(g[k] > p[k] for k in range(len(p)))
                               for g, p in zip(got, state["pads"])):
                        fits = True
                        break
                    freeze_from([tuple(g) for g in got])
                    img, counts = state["fused"](*args)
                if not fits:
                    _log.warning(
                        "bounced verify did not converge in 8 rounds "
                        "(counts %s vs pads %s); image may drop blocks",
                        np.asarray(counts).tolist(), state["pads"])
            return img

        render.pads = lambda: state["pads"]
        return render

    # -- public ----------------------------------------------------------

    def render(self, camera, block: bool = False):
        """Render a frame; returns a device array (H, W, 3) float32."""
        cam = camera.to_arrays() if isinstance(camera, Camera) else camera
        rays, ti, mask1, entry1, c1 = self._stage_a(
            cam, self._perm, self.block_lo, self.block_hi, self._live)
        p_pads, p_counts = self._size_pads(ti, mask1, entry1, c1,
                                           self.block_lo, self.block_hi)
        stage_b1 = self._stage_b_cache.get(p_pads)
        if stage_b1 is None:
            stage_b1 = jax.jit(functools.partial(self._stage_b1_fn, p_pads))
            self._stage_b_cache[p_pads] = stage_b1
        hits, hcount, _ = stage_b1(
            self.arrays, self.tris_packed,
            self.block_lo, self.block_hi, rays, ti, mask1, entry1, c1)

        ht_pad = _tile_bucket(int(hcount), self.n_tiles)
        bkey = ("b2", ht_pad)
        stage_b2 = self._stage_b_cache.get(bkey)
        if stage_b2 is None:
            stage_b2 = jax.jit(functools.partial(self._stage_b2_fn, ht_pad))
            self._stage_b_cache[bkey] = stage_b2
        (tpos, hit_tile, hits_h, prep, live_l, sti, smasks, sentries,
         sc1, ht_count) = stage_b2(self.arrays, self.shade_tbl,
                                   self.block_lo, self.block_hi, rays, hits)

        s_pads, s_counts = self._size_pads(sti, smasks, sentries, sc1,
                                           self.block_lo, self.block_hi)
        ckey = (s_pads, ht_pad)
        stage_c = self._stage_c_cache.get(ckey)
        if stage_c is None:
            stage_c = jax.jit(functools.partial(self._stage_c_fn, s_pads))
            self._stage_c_cache[ckey] = stage_c
        img, _ = stage_c(self.arrays, self.lights_scal,
                         self.block_lo, self.block_hi, cam, tpos, hit_tile,
                         hits_h, prep, live_l, sti, smasks, sentries, sc1)
        self._last_counts = p_counts + (int(ht_count),) + s_counts
        if block:
            jax.block_until_ready(img)
        return img

    # -- frozen fast path ------------------------------------------------
    #
    # The sync render pays two host round trips per frame to size the work
    # lists exactly. freeze() fixes the buckets (last observed counts x a
    # safety margin) and fuses all three stages into ONE jitted call with no
    # syncs — the interactive/benchmark path. Work-list overflow would drop
    # candidate blocks, so render_fast(verify=True) (or any sync render)
    # should be used periodically / during warmup to confirm margins hold;
    # on overflow freeze() is simply called again with the new counts.

    def _full_fn(self, pads: tuple, scene: SceneArrays,
                 tris_packed, lights_scal, shade_tbl, block_lo,
                 block_hi, perm, cam: CameraArrays, live=None):
        """pads layout == the counts layout: per-level primary buckets
        (n_levels), the hit-tile bucket, per-level shadow buckets."""
        nl = self.n_levels
        p_pads, h_pad, s_pads = pads[:nl], pads[nl], pads[nl + 1:]
        rays, ti, mask1, entry1, c1 = self._stage_a_fn(cam, perm, block_lo,
                                                       block_hi, live)
        hits, hcount, p_counts = self._stage_b1_fn(
            p_pads, scene, tris_packed,
            block_lo, block_hi, rays, ti, mask1, entry1, c1)
        (tpos, hit_tile, hits_h, prep, live_l, sti, smasks, sentries,
         sc1, ht_count) = self._stage_b2_fn(h_pad, scene, shade_tbl,
                                            block_lo, block_hi, rays, hits)
        img, s_counts = self._stage_c_fn(
            s_pads, scene, lights_scal, block_lo,
            block_hi, cam, tpos, hit_tile, hits_h, prep, live_l, sti,
            smasks, sentries, sc1)
        counts = jnp.stack([c1, *p_counts, ht_count, sc1, *s_counts]
                           ).astype(jnp.int32)
        return img, counts

    def freeze(self, camera=None, margin: float = 1.4) -> None:
        """Fix work-list buckets from the last sync render (running one if
        needed) and compile the fused no-sync pipeline."""
        if self._last_counts is None:
            if camera is None:
                raise ValueError("freeze() needs a camera for the sizing render")
            self.render(camera, block=True)
        pads = tuple(_bucket(c, margin) for c in self._last_counts)
        # The hit-TILE bucket has its own small granularity, capped at
        # n_tiles so overflow is structurally impossible at the cap.
        hi = self._ht_idx
        pads = (pads[:hi]
                + (_tile_bucket(int(self._last_counts[hi] * margin),
                                self.n_tiles),)
                + pads[hi + 1:])
        # Grow-only: a refreeze must never SHRINK a bucket. The verify
        # loops rebuild pads from the latest reported counts; without the
        # max a bucket could oscillate between rounds and the "each round
        # strictly grows some bucket" convergence argument would not hold.
        prev = getattr(self, "_frozen_pads", None)
        if prev is not None:
            pads = tuple(max(p, q) for p, q in zip(pads, prev))
        self._fused = jax.jit(functools.partial(self._full_fn, pads))
        self._frozen_pads = pads

    def render_many(self, cameras):
        """Render a BATCH of camera poses in ONE device dispatch.

        The frame pipeline is UNROLLED over the stacked camera pytree with
        the frozen buckets: frames still compute sequentially on the chip
        (identical images to render_fast), but the per-dispatch host cost
        is paid once per batch. Compile time scales with the batch length,
        so keep batches modest.

        This is the THROUGHPUT path (benchmark sweeps, offline animation
        rendering); the interactive loop keeps per-frame dispatches for
        latency. Returns (imgs (K, H, W, 3), counts (K, n_counts)) on
        device; callers should spot-check counts against frozen_pads as
        render_fast(verify=True) does.
        """
        cams = [c.to_arrays() if isinstance(c, Camera) else c
                for c in cameras]
        # Stack the camera batch on the HOST (numpy): jnp.stack over K tiny
        # pytree leaves would dispatch several separate micro-programs per
        # call. The single stacked host pytree ships once inside the fused
        # dispatch. (Device-resident leaves are pulled back first.)
        stacked = jax.tree.map(
            lambda *xs: np.stack([np.asarray(x) for x in xs]), *cams)
        if self._fused is None:
            self.freeze(cameras[0])
        k = len(cams)
        key = ("many", k, self._frozen_pads)
        fn = self._stage_b_cache.get(key)
        if fn is None:
            pads = self._frozen_pads

            def many_fn(scene, tris_packed, lights_scal,
                        shade_tbl, block_lo, block_hi, perm, cams):
                imgs, counts = [], []
                for i in range(k):
                    cam = jax.tree.map(lambda x: x[i], cams)
                    img, c = self._full_fn(
                        pads, scene, tris_packed, lights_scal,
                        shade_tbl, block_lo, block_hi, perm, cam)
                    imgs.append(img)
                    counts.append(c)
                return jnp.stack(imgs), jnp.stack(counts)

            fn = jax.jit(many_fn)
            self._stage_b_cache[key] = fn
        return fn(self.arrays, self.tris_packed,
                  self.lights_scal, self.shade_tbl, self.block_lo,
                  self.block_hi, self._perm, stacked)

    def render_fast(self, camera, verify: bool = False):
        """One fused dispatch, no host syncs. Returns a device array; with
        verify=True, blocks to check the frozen buckets still hold (and
        refreezes + rerenders if they overflowed).

        The verify pass LOOPS until every count fits its bucket: when a
        level-1 bucket overflows, the truncated level-1 list makes the
        reported level-2 counts undercounts, so a single refreeze-from-
        reported-counts could still drop fine cells — only a re-render
        whose counts all fit proves nothing was truncated."""
        cam = camera.to_arrays() if isinstance(camera, Camera) else camera
        if self._fused is None:
            self.freeze(camera)
        img, counts = self._fused(
            self.arrays, self.tris_packed, self.lights_scal,
            self.shade_tbl, self.block_lo, self.block_hi, self._perm, cam,
            self._live)
        if verify:
            fits = False
            for _ in range(8):   # each round strictly grows some bucket
                got = tuple(int(c) for c in np.asarray(counts))
                if all(g <= p for g, p in zip(got, self._frozen_pads)):
                    fits = True
                    break
                self._last_counts = got
                self.freeze(camera)   # grow-only (pads maxed with previous)
                img, counts = self._fused(
                    self.arrays, self.tris_packed,
                    self.lights_scal, self.shade_tbl, self.block_lo,
                    self.block_hi, self._perm, cam, self._live)
            if not fits:
                _log.warning(
                    "render_fast verify did not converge in 8 rounds "
                    "(counts %s vs pads %s); image may drop blocks",
                    tuple(int(c) for c in np.asarray(counts)),
                    self._frozen_pads)
        return img
