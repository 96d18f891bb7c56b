"""Block-BVH-culled geometry-sharded rendering (the production config-5 path).

parallel/halo.py routes rays to geometry shards but intersects every
received ray against every resident triangle densely — O(rays x T/N) per
shard per frame, unusable at multi-million-triangle scale. This module puts
the block BVH *inside* the sharded schedule: each shard culls the gathered
ray tiles against its OWN blocks' AABBs (ops/cull.py interval test) and runs
only surviving (tile, block) pairs through the Pallas BSR kernels
(ops/pallas/bsr_trace.py) — the same pruning the replicated path gets, the
reference applies to *every* query (tracer.go:32 scene R-tree +
object.go:76 face R-tree), now per shard.

Layout: scene.bake_bvh Morton-orders triangles and gap-aligns leaf blocks,
so a CONTIGUOUS run of blocks is spatially compact — sharding the block axis
contiguously gives each device a tight spatial region, which is exactly what
makes per-shard culling effective (most ray tiles miss most shards' AABBs
entirely and cull to zero work there).

Schedule per device (all shapes static; no host syncs in the frame):
  1. raygen for the FULL frame (replicated compute — the camera is
     replicated, so generating all rays locally is cheaper than an
     all_gather of them; rays are a pure function of the camera).
  2. cull (all ray tiles) x (local blocks) -> work list -> BSR nearest with
     this shard's global-id offset -> per-ray local candidate (t, gid).
  3. gather the candidate's 32-wide shading row from the LOCAL table (the
     owning shard is the only place the winning triangle's data lives) and
     all_to_all (t, gid, row) home; fold with the (t, then gid) lexicographic
     min — the same tie-break the kernels use, so fold order is irrelevant.
  4. shadow, per light: build REVERSED queries (light -> surface point,
     shade.PackedPrep.q_rev) for resident rays, all_gather them, cull vs
     local blocks with per-ray liveness (misses + zero-contribution lights
     masked out of the tile hulls), BSR any-hit, all_to_all the occlusion
     bits home, OR.
  5. Phong from the carried rows, purely local (shade.shade_core_rows).

Comm per frame: one all_to_all of (r x 34) f32 + per light one all_gather of
(8 x r) + one all_to_all of r bits — O(rays), independent of triangle count,
riding ICI. Geometry never moves.

Multi-bounce (bounces=N at construction): the hard mode — a REFLECTION ray
leaves its origin shard's geometry, so each bounce repeats the full
gather/cull/fold round: after the nearest fold, every shard builds its
resident rays' reflection queries locally (from the carried shading rows),
all_gathers the full reflection-ray set (+ liveness + self-exclusion ids),
culls it against its OWN blocks, runs the per-ray-origin BSR nearest, and
all_to_alls the candidates home again. Radiance accumulates per resident
ray exactly as the replicated path (ops/render_bvh.render_bounced):
colour += throughput * phong_b, throughput *= Ks, one final clamp. Dead
rays (miss / zero-Ks) are masked out of the tile hulls per bounce so they
cost no cull or kernel work anywhere. Comm per bounce: one all_gather of
(8 x r) rays + r liveness bits + r exclusion ids, then the same fold and
shadow rounds as the primary — still O(rays), never geometry.

Capability match: the reference's block-partitioned "distributed" identity
(BASELINE config 5) with the two-level R-tree pruning of
/root/reference/shared/state/object.go:76 applied to every query; the
bounce rounds are BASELINE.json's "secondary-ray halo exchange" north star.
"""

from __future__ import annotations

import functools
import logging
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

_log = logging.getLogger(__name__)

try:
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

from distributed_raytracer.models.camera import Camera, CameraArrays
from distributed_raytracer.models.scene import Scene
from distributed_raytracer.ops import cull, raygen, shade
from distributed_raytracer.ops.pallas import bsr_trace
from distributed_raytracer.utils.config import RenderConfig, DEFAULT_CONFIG

AXIS = "geom"
_bucket = bsr_trace.bucket_w_pad


def reflect_rows(cfg, prep, rays, valid):
    """Reflection rays + liveness from one bounce's shading prep —
    EXACTLY ops/render_bvh.CulledRenderer._reflect_from's math (shading
    normal for both the mirror and the epsilon lift). Shared by the halo
    and ring geometry-sharded schedules."""
    nrm = prep.normal
    d = rays[3:6]
    d_dot_n = jnp.sum(d * nrm, axis=0)
    refl = d - 2.0 * d_dot_n[None, :] * nrm
    rlen = jnp.sqrt(jnp.sum(refl * refl, axis=0, keepdims=True))
    refl = refl / jnp.where(rlen > 0, rlen, 1.0)
    side = jnp.where(jnp.sum(nrm * refl, axis=0) >= 0.0, 1.0, -1.0)
    o = (prep.x + cfg.shadow_offset * refl
         + (cfg.shadow_normal_offset * side)[None, :] * nrm)
    r_rays = bsr_trace.pack_rays_rows(o, refl)
    live = valid & jnp.any(prep.ks > 0.0, axis=0)
    return r_rays, live


class ShardedGeometry(NamedTuple):
    """Per-triangle/per-block arrays, sharded over the block axis."""

    tris16: jnp.ndarray    # (T, 16) bsr_trace.pack_tris columns
    table32: jnp.ndarray   # (T, 32) shade.pack_table rows
    block_lo: jnp.ndarray  # (NB, 3)
    block_hi: jnp.ndarray  # (NB, 3)
    base: jnp.ndarray      # (n,) int32 first global triangle id per shard


class DynGeometry(NamedTuple):
    """Ownership maps for per-frame object diffs on sharded geometry
    (scene.bake_bvh_grouped's outputs, sharded like ShardedGeometry)."""

    obj_id: jnp.ndarray     # (T,) int32 owning object per triangle slot
    block_obj: jnp.ndarray  # (NB,) int32 owning object per leaf block
    obj_pos0: jnp.ndarray   # (O, 3) f32 baked object positions (replicated)


def apply_diff_sharded(geom: ShardedGeometry, dyn: DynGeometry, diff):
    """Fold a SceneDiff into one shard's resident geometry (device, under
    shard_map) — ops/render_dynamic.py's translation transform applied to
    the LOCAL rows: every worker applies every diff, whatever the topology
    (environment.go:73-98, worker/distributed/main.go:56-64).

    Translation-only placement means a shift d touches exactly plane_d,
    c_u, c_v (per-triangle scalars), the shading table's p0 rows, and the
    whole-object leaf-block AABBs (bake_bvh_grouped guarantees one owner
    per block, so the shift is exact). Inverted padding AABBs stay
    inverted (±inf + finite = ±inf) and keep culling to nothing.
    """
    delta = (diff.obj_pos - dyn.obj_pos0).astype(jnp.float32)     # (O, 3)
    dt = delta[dyn.obj_id]                                        # (T, 3)
    t16 = geom.tris16
    geo_n, ku, kv = t16[:, 0:3], t16[:, 4:7], t16[:, 8:11]
    plane = t16[:, 3:4] + jnp.sum(geo_n * dt, 1, keepdims=True)
    cu = t16[:, 7:8] - jnp.sum(ku * dt, 1, keepdims=True)
    cv = t16[:, 11:12] - jnp.sum(kv * dt, 1, keepdims=True)
    tris16_d = jnp.concatenate([geo_n, plane, ku, cu, kv, cv, t16[:, 12:]],
                               axis=1)
    db = delta[dyn.block_obj]
    return geom._replace(tris16=tris16_d,
                         table32=geom.table32.at[:, 0:3].add(dt),
                         block_lo=geom.block_lo + db,
                         block_hi=geom.block_hi + db)


def _pad_to_shardable(arrays, tree, n: int, align: int = 1):
    """Append degenerate blocks so the block count divides the mesh size
    (and, with align > 1, each shard's block count divides the local cull
    grouping so superblocks never straddle shards).

    Padding triangles are all-zero (den == num == 0 -> never hit) and padding
    blocks carry inverted AABBs (+inf, -inf) that no interval test passes.
    """
    nb = tree.num_blocks
    nb_ext = -(-nb // (n * align)) * (n * align)
    if nb_ext == nb:
        return arrays, tree.block_lo, tree.block_hi
    bs = tree.block_size
    pad_t = (nb_ext - nb) * bs
    per_tri = {"p0", "e1", "e2", "geo_n", "plane_d", "k_u", "k_v",
               "c_u", "c_v", "n0", "n1", "n2", "mat_id"}
    rep = {}
    for name in per_tri:
        a = np.asarray(getattr(arrays, name))
        width = [(0, pad_t)] + [(0, 0)] * (a.ndim - 1)
        rep[name] = np.pad(a, width)
    arrays = arrays._replace(**rep)
    lo = np.concatenate([tree.block_lo,
                         np.full((nb_ext - nb, 3), np.inf, np.float32)])
    hi = np.concatenate([tree.block_hi,
                         np.full((nb_ext - nb, 3), -np.inf, np.float32)])
    return arrays, lo, hi


class HaloCulledRenderer:
    """Geometry-sharded renderer with per-shard block-BVH culling.

    Work-list buckets must be static under shard_map, so they are sized at
    build time from `sizing_camera` (a one-device pass over the full scene)
    x `margin`, maxed across shards and lights. render(cam, verify=True)
    blocks to check the frame's true counts against the buckets and
    re-sizes + re-renders on overflow — the sharded analog of
    CulledRenderer.render_fast(verify=True); without it a camera far outside
    the sizing pose could silently drop candidate blocks (the reference
    never shows a wrong tile — master/main.go:153-161).
    """

    def __init__(self, scene: Scene, width: int, height: int,
                 mesh: Optional[Mesh] = None,
                 sizing_camera: Optional[Camera] = None,
                 margin: float = 2.0, cfg: RenderConfig = DEFAULT_CONFIG,
                 block_size: int = 128, ray_tile: int = 512,
                 dynamic: bool = False,
                 bounces: int = 0, local_levels: Optional[int] = None,
                 local_group: int = 16):
        if mesh is None:
            mesh = jax.make_mesh((len(jax.devices()),), (AXIS,))
        self.bounces = int(bounces)
        self.mesh = mesh
        self.n = int(mesh.devices.size)
        self.width, self.height, self.cfg = width, height, cfg
        self.rt, self.tb = ray_tile, block_size
        self.margin = margin

        # dynamic=True bakes with per-object Morton grouping so per-frame
        # SceneDiff translations shift leaf-block AABBs exactly
        # (render_dynamic below — the sharded analog of
        # ops/render_dynamic.DynamicCulledRenderer).
        if dynamic:
            (arrays, tree, obj_id, block_obj,
             obj_pos0) = scene.bake_bvh_grouped(block_size=block_size)
        else:
            arrays, tree = scene.bake_bvh(block_size=block_size)
        nb_orig = tree.num_blocks
        # Per-shard cull hierarchy: each shard culls the gathered rays
        # against its OWN blocks; above ~1024 resident blocks the flat
        # (tiles x blocks) mask + compaction argsort dominates, so a local
        # superblock level is added (cull.multilevel_* with groups that
        # never straddle shards — the block padding aligns to it).
        # loc_groups == () degenerates to the flat single-level walk.
        prelim_loc = -(-tree.num_blocks // self.n)
        if local_levels is None:
            local_levels = 2 if prelim_loc >= 1024 else 1
        self.loc_groups = (local_group,) * (local_levels - 1)
        arrays, lo, hi = _pad_to_shardable(
            arrays, tree, self.n,
            align=local_group if self.loc_groups else 1)
        self.nb_ext = lo.shape[0]
        self.nb_loc = self.nb_ext // self.n
        self.t_loc = self.nb_loc * block_size
        self.lights_pos = jnp.asarray(arrays.light_pos)
        self.lights_col = jnp.asarray(arrays.light_col)
        self.n_lights = int(self.lights_pos.shape[0])

        tris16 = np.asarray(bsr_trace.pack_tris(arrays))
        table32 = np.asarray(shade.pack_table(arrays))
        base = (np.arange(self.n, dtype=np.int32) * self.t_loc)

        sh = lambda spec: NamedSharding(mesh, spec)
        self.geom = ShardedGeometry(
            tris16=jax.device_put(tris16, sh(P(AXIS))),
            table32=jax.device_put(table32, sh(P(AXIS))),
            block_lo=jax.device_put(lo, sh(P(AXIS))),
            block_hi=jax.device_put(hi, sh(P(AXIS))),
            base=jax.device_put(base, sh(P(AXIS))),
        )
        if dynamic:
            # Pad the ownership maps alongside _pad_to_shardable (padding
            # slots/blocks chart to object 0: degenerate triangles never
            # hit and inverted AABBs never pass, so any owner works).
            pad_b = lo.shape[0] - nb_orig
            obj_id = np.pad(np.asarray(obj_id, np.int32),
                            (0, pad_b * block_size))
            block_obj = np.pad(np.asarray(block_obj, np.int32), (0, pad_b))
            self._dyn = DynGeometry(
                obj_id=jax.device_put(obj_id, sh(P(AXIS))),
                block_obj=jax.device_put(block_obj, sh(P(AXIS))),
                obj_pos0=jax.device_put(
                    np.asarray(obj_pos0, np.float32), sh(P())))
        else:
            self._dyn = None
        # Full-geometry copies for the build-time sizing pass only (freed
        # after sizing; the frame path touches only the sharded values).
        self._full = (jnp.asarray(tris16), jnp.asarray(table32),
                      jnp.asarray(lo), jnp.asarray(hi))

        # 2D screen-tile ray layout, padded so tiles divide across shards.
        self.tile_w = 32
        self.tile_h = ray_tile // self.tile_w
        perm, _, n_pad = cull.tiled_ray_order(width, height,
                                              self.tile_w, self.tile_h)
        self.n_pad = n_pad
        nt = n_pad // ray_tile
        nt_ext = -(-nt // self.n) * self.n
        self.n_pad_ext = nt_ext * ray_tile
        if self.n_pad_ext > n_pad:
            perm = np.concatenate([perm, np.full(
                (self.n_pad_ext - n_pad,), width * height - 1, np.int32)])
        self.r_loc = self.n_pad_ext // self.n
        self._perm = jax.device_put(jnp.asarray(perm), sh(P()))

        camera = sizing_camera if sizing_camera is not None else scene.camera
        if self.bounces:
            counts = self._sizing_counts_bounced(camera, self.bounces)
            self._freeze_bounced(counts)
            self.last_counts = counts   # (B+1, n, 2) per bounce, per shard
        else:
            counts = self._sizing_counts(camera)
            self._freeze(counts)
            self.last_counts = counts   # (n, 2) (primary, max shadow)
        self._full = None

    # -- sizing (build time, one device, full geometry) --------------------

    def _size_a(self, cam, perm, blo, bhi):
        d_rows = raygen.ray_rows_flat(cam, self.width, self.height, perm)
        rays = bsr_trace.pack_rays_rows(cam.pos, d_rows)
        ti = cull.tile_intervals_packed(rays, self.rt)
        mask, entry = cull.block_mask_with_entry(ti, blo, bhi)
        return rays, ti, mask, entry

    def _per_shard(self, mask):
        """(nt, n*W) mask -> (n,) per-shard kept-cell counts (W = any
        per-shard level width; shard alignment is guaranteed by the block
        padding)."""
        nt = mask.shape[0]
        return mask.reshape(nt, self.n, -1).sum(axis=(0, 2))

    def _per_shard_levels(self, ti, mask_flat, blo, bhi):
        """(L+1, n) per-shard kept cells at every LOCAL cull level,
        coarsest first. The flat full-geometry mask gives the finest
        level; coarser levels re-test the same tile hulls against the
        local-group union AABBs."""
        rows = []
        for k in range(len(self.loc_groups), 0, -1):
            lo, hi = cull.level_bounds(blo, bhi, self.loc_groups[:k])[-1]
            m, _ = cull.block_mask_with_entry(ti, lo, hi)
            rows.append(self._per_shard(m))
        rows.append(self._per_shard(mask_flat))
        return jnp.stack(rows)

    def _size_b(self, w_full, tris16, table32, blo, bhi, cam, rays,
                mask, entry):
        wl = cull.compact_worklist(mask, w_full, entry=entry)
        tris_cam = bsr_trace.pack_tris_origin(tris16, cam.pos)
        no_excl = jnp.full((self.n_pad_ext,), -1, jnp.int32)
        bt, bi = bsr_trace.bsr_nearest(
            rays, no_excl, tris_cam, wl.tile_ids, wl.block_ids,
            wl.count, rt=self.rt, tb=self.tb, shared_origin=True)
        visited = jnp.repeat(mask.any(axis=1), self.rt)
        bt = jnp.where(visited, bt, jnp.inf)
        valid = jnp.isfinite(bt)
        g = table32[jnp.clip(bi, 0, table32.shape[0] - 1)].T
        prep = shade.prepare_packed_rows(self.lights_pos, rays,
                                         jnp.where(valid, bt, 0.0), g,
                                         self.cfg)
        live_l = shade.light_gates_rows(self.lights_col, cam.pos, prep, valid)
        nl = len(self.loc_groups) + 1
        per_ls = []
        for li in range(self.n_lights):
            ti_s = cull.tile_intervals_packed(prep.q_rev[li], self.rt,
                                              live=live_l[li], use_tmax=True)
            smask, _ = cull.block_mask_with_entry(ti_s, blo, bhi)
            per_ls.append(self._per_shard_levels(ti_s, smask, blo, bhi))
        return (jnp.stack(per_ls) if per_ls
                else jnp.zeros((0, nl, self.n), jnp.int32))

    def _sizing_counts(self, camera) -> np.ndarray:
        """(n, 2*(L+1)) int: per-shard per-LOCAL-level primary cells then
        shadow cells (coarsest..finest; max over lights), for `camera` —
        the bucket-sizing inputs. L = len(loc_groups); the historical
        (n, 2) layout is the L = 0 case."""
        cam = camera.to_arrays() if isinstance(camera, Camera) else camera
        tris16, table32, blo, bhi = self._full
        nl = len(self.loc_groups) + 1
        rays, ti, mask, entry = jax.jit(self._size_a)(cam, self._perm,
                                                      blo, bhi)
        p_levels = np.asarray(jax.jit(self._per_shard_levels)(
            ti, mask, blo, bhi))                         # (nl, n)
        w_full = _bucket(int(mask.sum()))
        size_b = jax.jit(functools.partial(self._size_b, w_full))
        per_ls = np.asarray(size_b(tris16, table32, blo, bhi, cam, rays,
                                   mask, entry))         # (L_lights, nl, n)
        s_levels = (per_ls.max(axis=0) if per_ls.size
                    else np.zeros((nl, self.n), np.int64))
        return np.concatenate([p_levels, s_levels]).T    # (n, 2*nl)

    # -- bounce sizing (build time, one device, full geometry) --------------

    def _reflect_rows(self, prep, rays, valid):
        return reflect_rows(self.cfg, prep, rays, valid)

    def _size_mask(self, blo, bhi, rays, live):
        ti = cull.tile_intervals_packed(rays, self.rt, live=live)
        mask, entry = cull.block_mask_with_entry(ti, blo, bhi)
        return ti, mask, entry, mask.sum().astype(jnp.int32)

    def _size_bounce_step(self, shared: bool, w_full: int, tris16, table32,
                          blo, bhi, rays, live, excl, view, mask, entry):
        """One bounce of the sizing walk on full geometry. Returns the
        per-light per-shard shadow counts plus the next bounce's state."""
        wl = cull.compact_worklist(mask, w_full, entry=entry)
        tris_arg = (bsr_trace.pack_tris_origin(tris16, rays[0:3, 0])
                    if shared else tris16)
        bt, bi = bsr_trace.bsr_nearest(
            rays, excl, tris_arg, wl.tile_ids, wl.block_ids,
            wl.count, rt=self.rt, tb=self.tb, shared_origin=shared)
        visited = jnp.repeat(mask.any(axis=1), self.rt)
        bt = jnp.where(visited, bt, jnp.inf)
        bi = jnp.where(visited, bi, jnp.int32(bsr_trace.BIG_IDX))
        valid = jnp.isfinite(bt) & live
        g = table32[jnp.clip(bi, 0, table32.shape[0] - 1)].T
        prep = shade.prepare_packed_rows(self.lights_pos, rays,
                                         jnp.where(valid, bt, 0.0), g,
                                         self.cfg)
        live_l = shade.light_gates_rows(self.lights_col, view, prep, valid)
        nl = len(self.loc_groups) + 1
        per_ls = []
        for li in range(self.n_lights):
            ti_s = cull.tile_intervals_packed(prep.q_rev[li], self.rt,
                                              live=live_l[li], use_tmax=True)
            smask, _ = cull.block_mask_with_entry(ti_s, blo, bhi)
            per_ls.append(self._per_shard_levels(ti_s, smask, blo, bhi))
        per_s = (jnp.stack(per_ls) if per_ls
                 else jnp.zeros((0, nl, self.n), jnp.int32))
        r_rays, live2 = self._reflect_rows(prep, rays, valid)
        excl2 = jnp.where(valid, bi, -1)
        return per_s, r_rays, live2, excl2, prep.x

    def _sizing_counts_bounced(self, camera, depth: int) -> np.ndarray:
        """(B+1, n, 2*(L+1)): per-bounce per-shard per-LOCAL-level
        (primary cells then max-per-light shadow cells) on full geometry —
        the bounce bucket-sizing inputs."""
        cam = camera.to_arrays() if isinstance(camera, Camera) else camera
        tris16, table32, blo, bhi = self._full
        d_rows = raygen.ray_rows_flat(cam, self.width, self.height,
                                      self._perm)
        rays = bsr_trace.pack_rays_rows(cam.pos, d_rows)
        live = jnp.ones((self.n_pad_ext,), bool)
        excl = jnp.full((self.n_pad_ext,), -1, jnp.int32)
        view = cam.pos
        size_mask = jax.jit(self._size_mask)
        levels = jax.jit(self._per_shard_levels)
        out = []
        for b in range(depth + 1):
            ti, mask, entry, c = size_mask(blo, bhi, rays, live)
            per_p = np.asarray(levels(ti, mask, blo, bhi))   # (nl, n)
            w_full = _bucket(int(c))
            step = jax.jit(functools.partial(self._size_bounce_step,
                                             b == 0, w_full))
            per_ls, rays, live, excl, view = step(
                tris16, table32, blo, bhi, rays, live, excl, view, mask,
                entry)
            per_ls = np.asarray(per_ls)
            nl = len(self.loc_groups) + 1
            per_s = (per_ls.max(axis=0) if per_ls.size
                     else np.zeros((nl, self.n), np.int64))
            out.append(np.concatenate([per_p, per_s]).T)   # (n, 2*nl)
        return np.stack(out)

    # -- the sharded frame --------------------------------------------------

    def _shard_fn(self, w_pads: tuple, w_pads_sh: tuple, cam: CameraArrays,
                  geom: ShardedGeometry, perm, lights_pos, lights_col,
                  dyn: Optional[DynGeometry] = None, diff=None):
        n, rt, tb = self.n, self.rt, self.tb
        if diff is not None:
            # Every shard folds the frame's diff into its resident rows
            # before any culling — environment.go:73-98's "every worker
            # applies every diff", minus the R-tree rebuild (block AABBs
            # shift exactly under the grouped bake; the local superblock
            # unions recompute from the shifted blocks inside the
            # multilevel walk, so the hierarchy stays exact).
            geom = apply_diff_sharded(geom, dyn, diff)
        gid0 = geom.base[0]

        # 1-2: full-frame rays, hierarchical cull vs LOCAL blocks
        # (loc_groups=() is the flat single-level walk), local BSR nearest.
        d_rows = raygen.ray_rows_flat(cam, self.width, self.height, perm)
        rays = bsr_trace.pack_rays_rows(cam.pos, d_rows)   # (8, n_pad_ext)
        ti = cull.tile_intervals_packed(rays, rt)
        mask, entry, c_top = cull.multilevel_mask(
            ti, geom.block_lo, geom.block_hi, self.loc_groups)
        wl, p_exp = cull.multilevel_worklist(
            ti, mask, entry, c_top, geom.block_lo, geom.block_hi,
            self.loc_groups, w_pads)
        p_counts = (c_top.astype(jnp.int32),) + tuple(
            c.astype(jnp.int32) for c in p_exp)
        tris_cam = bsr_trace.pack_tris_origin(geom.tris16, cam.pos)
        no_excl = jnp.full((self.n_pad_ext,), -1, jnp.int32)
        bt, bi = bsr_trace.bsr_nearest(
            rays, no_excl, tris_cam, wl.tile_ids, wl.block_ids,
            wl.count, gid_base=gid0, rt=rt, tb=tb, shared_origin=True)
        visited = jnp.repeat(cull.visited_tiles(wl, self.n_pad_ext // rt),
                             rt)
        bt = jnp.where(visited, bt, jnp.inf)
        bi = jnp.where(visited, bi, jnp.int32(bsr_trace.BIG_IDX))

        # 3: candidate shading rows from the LOCAL table; candidates home.
        loc = jnp.clip(bi - gid0, 0, geom.tris16.shape[0] - 1)
        grows = geom.table32[loc]                          # (n_pad_ext, 32)
        a2a = lambda x: jax.lax.all_to_all(x, AXIS, split_axis=0,
                                           concat_axis=0, tiled=True)
        bt_h = a2a(bt).reshape(n, self.r_loc)
        bi_h = a2a(bi).reshape(n, self.r_loc)
        g_h = a2a(grows).reshape(n, self.r_loc, 32)
        best_t, best_i, best_g = bt_h[0], bi_h[0], g_h[0]
        for s in range(1, n):
            better = ((bt_h[s] < best_t)
                      | ((bt_h[s] == best_t) & (bi_h[s] < best_i)))
            best_t = jnp.where(better, bt_h[s], best_t)
            best_i = jnp.where(better, bi_h[s], best_i)
            best_g = jnp.where(better[:, None], g_h[s], best_g)
        valid = jnp.isfinite(best_t)

        # 4: resident shadow queries out, occlusion bits home.
        me = jax.lax.axis_index(AXIS)
        my_rays = jax.lax.dynamic_slice(
            rays, (0, me * self.r_loc), (8, self.r_loc))
        prep = shade.prepare_packed_rows(
            lights_pos, my_rays, jnp.where(valid, best_t, 0.0),
            best_g.T, self.cfg)
        live_l = shade.light_gates_rows(lights_col, cam.pos, prep, valid)
        excl = jnp.where(valid, best_i, -1)
        nl = len(self.loc_groups) + 1
        lit = []
        s_counts = [jnp.int32(0)] * nl
        for li in range(self.n_lights):
            q_g = jax.lax.all_gather(prep.q_rev[li], AXIS, axis=1, tiled=True)
            live_g = jax.lax.all_gather(live_l[li], AXIS, tiled=True)
            excl_g = jax.lax.all_gather(excl, AXIS, tiled=True)
            ti_s = cull.tile_intervals_packed(q_g, rt, live=live_g,
                                              use_tmax=True)
            smask, sentry, sc_top = cull.multilevel_mask(
                ti_s, geom.block_lo, geom.block_hi, self.loc_groups)
            swl, s_exp = cull.multilevel_worklist(
                ti_s, smask, sentry, sc_top, geom.block_lo, geom.block_hi,
                self.loc_groups, w_pads_sh)
            lv = (sc_top.astype(jnp.int32),) + tuple(
                c.astype(jnp.int32) for c in s_exp)
            s_counts = [jnp.maximum(a, b) for a, b in zip(s_counts, lv)]
            tris_l = bsr_trace.pack_tris_origin(geom.tris16,
                                                lights_pos[li])
            hit = bsr_trace.bsr_any(
                q_g, excl_g, tris_l, swl.tile_ids, swl.block_ids,
                swl.count, gid_base=gid0, rt=rt, tb=tb, shared_origin=True)
            s_visited = cull.visited_tiles(swl, self.n_pad_ext // rt)
            hit = jnp.where(jnp.repeat(s_visited, rt), hit, 0)
            hit_h = a2a(hit).reshape(n, self.r_loc)
            lit.append(hit_h.max(axis=0) == 0)
        lit = (jnp.stack(lit) if lit
               else jnp.zeros((0, self.r_loc), bool))

        # 5: local Phong from the carried rows.
        colour = shade.shade_core_rows(lights_col, cam.pos, prep,
                                       valid, lit)
        counts = jnp.stack([*p_counts, *s_counts])[None, :]  # (1, 2*nl)
        return colour, counts

    def _shard_fn_bounced(self, w_pads: tuple, w_pads_sh: tuple,
                          cam: CameraArrays, geom: ShardedGeometry, perm,
                          lights_pos, lights_col,
                          dyn: Optional[DynGeometry] = None, diff=None):
        """N-bounce Whitted frame on sharded geometry (module docstring
        "Multi-bounce"). Semantics match CulledRenderer.render_bounced
        exactly; the fold tie-break (t, then global id) makes the radiance
        independent of shard order. With `diff`, the frame's SceneDiff
        folds into each shard's resident rows BEFORE bounce 0 — every
        bounce's cull, trace, and shading then see the updated geometry
        (environment.go:73-98's every-worker-applies-every-diff)."""
        n, rt, tb = self.n, self.rt, self.tb
        if diff is not None:
            geom = apply_diff_sharded(geom, dyn, diff)
        gid0 = geom.base[0]
        me = jax.lax.axis_index(AXIS)
        a2a = lambda x: jax.lax.all_to_all(x, AXIS, split_axis=0,
                                           concat_axis=0, tiled=True)

        d_rows = raygen.ray_rows_flat(cam, self.width, self.height, perm)
        rays_all = bsr_trace.pack_rays_rows(cam.pos, d_rows)
        live_all = jnp.ones((self.n_pad_ext,), bool)
        excl_all = jnp.full((self.n_pad_ext,), -1, jnp.int32)
        colour = jnp.zeros((3, self.r_loc), jnp.float32)
        throughput = jnp.ones((3, self.r_loc), jnp.float32)
        view = cam.pos
        counts = []
        nl = len(self.loc_groups) + 1
        for b in range(self.bounces + 1):
            # hierarchical cull vs LOCAL blocks over the gathered ray set
            ti = cull.tile_intervals_packed(rays_all, rt, live=live_all)
            mask, entry, c_top = cull.multilevel_mask(
                ti, geom.block_lo, geom.block_hi, self.loc_groups)
            wl, p_exp = cull.multilevel_worklist(
                ti, mask, entry, c_top, geom.block_lo, geom.block_hi,
                self.loc_groups, w_pads[b])
            p_counts = (c_top.astype(jnp.int32),) + tuple(
                c.astype(jnp.int32) for c in p_exp)
            if b == 0:
                tris_arg = bsr_trace.pack_tris_origin(geom.tris16, cam.pos)
            else:
                tris_arg = geom.tris16      # per-ray origins
            bt, bi = bsr_trace.bsr_nearest(
                rays_all, excl_all, tris_arg, wl.tile_ids, wl.block_ids,
                wl.count, gid_base=gid0, rt=rt, tb=tb,
                shared_origin=(b == 0))
            visited = jnp.repeat(
                cull.visited_tiles(wl, self.n_pad_ext // rt), rt)
            bt = jnp.where(visited, bt, jnp.inf)
            bi = jnp.where(visited, bi, jnp.int32(bsr_trace.BIG_IDX))

            # candidates (t, gid, local shading row) home; fold
            loc = jnp.clip(bi - gid0, 0, geom.tris16.shape[0] - 1)
            grows = geom.table32[loc]
            bt_h = a2a(bt).reshape(n, self.r_loc)
            bi_h = a2a(bi).reshape(n, self.r_loc)
            g_h = a2a(grows).reshape(n, self.r_loc, 32)
            best_t, best_i, best_g = bt_h[0], bi_h[0], g_h[0]
            for s in range(1, n):
                better = ((bt_h[s] < best_t)
                          | ((bt_h[s] == best_t) & (bi_h[s] < best_i)))
                best_t = jnp.where(better, bt_h[s], best_t)
                best_i = jnp.where(better, bi_h[s], best_i)
                best_g = jnp.where(better[:, None], g_h[s], best_g)
            live_res = jax.lax.dynamic_slice(live_all, (me * self.r_loc,),
                                             (self.r_loc,))
            valid = jnp.isfinite(best_t) & live_res

            # resident shadow round (as the primary-only path)
            my_rays = jax.lax.dynamic_slice(
                rays_all, (0, me * self.r_loc), (8, self.r_loc))
            prep = shade.prepare_packed_rows(
                lights_pos, my_rays, jnp.where(valid, best_t, 0.0),
                best_g.T, self.cfg)
            live_l = shade.light_gates_rows(lights_col, view, prep, valid)
            excl_sh = jnp.where(valid, best_i, -1)
            excl_g = jax.lax.all_gather(excl_sh, AXIS, tiled=True)
            lit = []
            s_counts = [jnp.int32(0)] * nl
            for li in range(self.n_lights):
                q_g = jax.lax.all_gather(prep.q_rev[li], AXIS, axis=1,
                                         tiled=True)
                live_g = jax.lax.all_gather(live_l[li], AXIS, tiled=True)
                ti_s = cull.tile_intervals_packed(q_g, rt, live=live_g,
                                                  use_tmax=True)
                smask, sentry, sc_top = cull.multilevel_mask(
                    ti_s, geom.block_lo, geom.block_hi, self.loc_groups)
                swl, s_exp = cull.multilevel_worklist(
                    ti_s, smask, sentry, sc_top, geom.block_lo,
                    geom.block_hi, self.loc_groups, w_pads_sh[b])
                lv = (sc_top.astype(jnp.int32),) + tuple(
                    c.astype(jnp.int32) for c in s_exp)
                s_counts = [jnp.maximum(a, c) for a, c in zip(s_counts, lv)]
                tris_l = bsr_trace.pack_tris_origin(geom.tris16,
                                                    lights_pos[li])
                hit = bsr_trace.bsr_any(
                    q_g, excl_g, tris_l, swl.tile_ids, swl.block_ids,
                    swl.count, gid_base=gid0, rt=rt, tb=tb,
                    shared_origin=True)
                s_visited = cull.visited_tiles(swl, self.n_pad_ext // rt)
                hit = jnp.where(jnp.repeat(s_visited, rt), hit, 0)
                hit_h = a2a(hit).reshape(n, self.r_loc)
                lit.append(hit_h.max(axis=0) == 0)
            lit = (jnp.stack(lit) if lit
                   else jnp.zeros((0, self.r_loc), bool))

            local = shade.shade_core_rows(lights_col, view, prep, valid,
                                          lit)
            colour = colour + throughput * local
            counts.append(jnp.stack([*p_counts, *s_counts]))
            if b == self.bounces:
                break
            throughput = jnp.where(valid[None, :],
                                   throughput * prep.ks, 0.0)
            # next bounce: resident reflections -> gathered full set
            r_rays, live2 = self._reflect_rows(prep, my_rays, valid)
            rays_all = jax.lax.all_gather(r_rays, AXIS, axis=1, tiled=True)
            live_all = jax.lax.all_gather(live2, AXIS, tiled=True)
            excl_all = excl_g
            view = prep.x
        colour = jnp.clip(colour, 0.0, 1.0)
        return colour, jnp.stack(counts)[None]    # (3, r_loc), (1, B+1, 2)

    def _freeze_bounced(self, counts: np.ndarray) -> None:
        """Compile the bounce pipeline with per-bounce buckets from the
        (B+1, n, 2*(L+1)) sizing counts x margin, grow-only across
        refreezes. Each bounce gets per-LOCAL-level bucket tuples."""
        nl = len(self.loc_groups) + 1
        worst = counts.max(axis=1)                 # (B+1, 2*nl)
        w_pads = tuple(tuple(_bucket(int(w), self.margin)
                             for w in worst[b, :nl])
                       for b in range(worst.shape[0]))
        w_pads_sh = tuple(tuple(_bucket(int(w), self.margin)
                                for w in worst[b, nl:])
                          for b in range(worst.shape[0]))
        prev = getattr(self, "w_pads", None)
        if prev is not None:
            w_pads = tuple(tuple(max(a, b) for a, b in zip(q, pq))
                           for q, pq in zip(w_pads, prev))
            w_pads_sh = tuple(tuple(max(a, b) for a, b in zip(q, pq))
                              for q, pq in zip(w_pads_sh, self.w_pads_sh))
        self.w_pads, self.w_pads_sh = w_pads, w_pads_sh
        fn = functools.partial(self._shard_fn_bounced, w_pads, w_pads_sh)
        geom_specs = ShardedGeometry(
            tris16=P(AXIS), table32=P(AXIS), block_lo=P(AXIS),
            block_hi=P(AXIS), base=P(AXIS))
        self._render_jit = jax.jit(shard_map(
            fn, mesh=self.mesh,
            in_specs=(P(), geom_specs, P(), P(), P()),
            out_specs=(P(None, AXIS), P(AXIS)),
            check_vma=False,
        ))
        if self._dyn is not None:
            from distributed_raytracer.models.scene import SceneDiff

            dyn_specs = DynGeometry(obj_id=P(AXIS), block_obj=P(AXIS),
                                    obj_pos0=P())
            diff_specs = SceneDiff(*(P() for _ in SceneDiff._fields))
            self._render_dyn_jit = jax.jit(shard_map(
                fn, mesh=self.mesh,
                in_specs=(P(), geom_specs, P(), P(), P(), dyn_specs,
                          diff_specs),
                out_specs=(P(None, AXIS), P(AXIS)),
                check_vma=False,
            ))

    def _freeze(self, counts: np.ndarray) -> None:
        from distributed_raytracer.models.scene import SceneDiff

        nl = len(self.loc_groups) + 1
        w_pads = tuple(_bucket(int(counts[:, k].max()), self.margin)
                       for k in range(nl))
        w_pads_sh = tuple(
            _bucket(int(counts[:, nl + k].max()), self.margin)
            for k in range(nl))
        # Grow-only across refreezes (as _freeze_bounced): the verify loops
        # rebuild from the latest reported counts, and without the max a
        # bucket could oscillate and break the each-round-strictly-grows
        # convergence argument.
        prev = getattr(self, "w_pads", None)
        if prev is not None and len(prev) == nl:
            w_pads = tuple(max(a, b) for a, b in zip(w_pads, prev))
            w_pads_sh = tuple(max(a, b)
                              for a, b in zip(w_pads_sh, self.w_pads_sh))
        self.w_pads, self.w_pads_sh = w_pads, w_pads_sh
        # Finest-level aliases (kept for diagnostics/tests).
        self.w_pad, self.w_pad_sh = self.w_pads[-1], self.w_pads_sh[-1]
        fn = functools.partial(self._shard_fn, self.w_pads, self.w_pads_sh)
        geom_specs = ShardedGeometry(
            tris16=P(AXIS), table32=P(AXIS), block_lo=P(AXIS),
            block_hi=P(AXIS), base=P(AXIS))
        self._render_jit = jax.jit(shard_map(
            fn, mesh=self.mesh,
            in_specs=(P(), geom_specs, P(), P(), P()),
            out_specs=(P(None, AXIS), P(AXIS)),
            check_vma=False,
        ))
        if self._dyn is not None:
            dyn_specs = DynGeometry(obj_id=P(AXIS), block_obj=P(AXIS),
                                    obj_pos0=P())
            diff_specs = SceneDiff(*(P() for _ in SceneDiff._fields))
            self._render_dyn_jit = jax.jit(shard_map(
                fn, mesh=self.mesh,
                in_specs=(P(), geom_specs, P(), P(), P(), dyn_specs,
                          diff_specs),
                out_specs=(P(None, AXIS), P(AXIS)),
                check_vma=False,
            ))

    # -- public -------------------------------------------------------------

    def device_fn(self, cam: CameraArrays):
        """(colour rows (3, n_pad_ext), per-shard per-level counts) on device."""
        return self._render_jit(cam, self.geom, self._perm,
                                self.lights_pos, self.lights_col)

    def _assemble(self, rows: jnp.ndarray) -> np.ndarray:
        tw, th = self.tile_w, self.tile_h
        tx, ty = -(-self.width // tw), -(-self.height // th)
        img = np.asarray(rows)[:, :self.n_pad]
        img = img.reshape(3, ty, tx, th, tw).transpose(1, 3, 2, 4, 0)
        img = img.reshape(ty * th, tx * tw, 3)
        return img[:self.height, :self.width]

    def render(self, camera, verify: bool = False) -> np.ndarray:
        """With verify=True, LOOP until every reported count fits its
        bucket (up to 8 grow-only refreezes), as CulledRenderer.render_fast:
        with the hierarchical local cull a truncated top-level compaction
        makes the finer-level expansion counts UNDERCOUNTS, and in the
        bounced pipeline later bounces' ray sets derive from earlier
        (possibly truncated) nearest results — so a single refreeze from
        reported counts can still drop candidate blocks. Only a re-render
        whose counts all fit proves nothing was truncated."""
        cam = camera.to_arrays() if isinstance(camera, Camera) else camera
        rows, counts = self.device_fn(cam)
        if verify:
            nl = len(self.loc_groups) + 1
            fits = False
            for _ in range(8):   # each round strictly grows some bucket
                c = np.asarray(counts)
                if self.bounces:
                    # counts: (n, B+1, 2*nl)
                    worst = c.max(axis=0)        # (B+1, 2*nl)
                    if all(int(worst[b, k]) <= (self.w_pads[b] +
                                                self.w_pads_sh[b])[k]
                           for b in range(self.bounces + 1)
                           for k in range(2 * nl)):
                        fits = True
                        break
                    self._freeze_bounced(c.transpose(1, 0, 2))
                else:
                    pads_vec = self.w_pads + self.w_pads_sh
                    if all(int(c[:, k].max()) <= pads_vec[k]
                           for k in range(2 * nl)):
                        fits = True
                        break
                    self._freeze(c)              # re-size from true counts
                rows, counts = self.device_fn(cam)
            if not fits:
                _log.warning(
                    "halo verify did not converge in 8 rounds (counts %s); "
                    "image may drop blocks", np.asarray(counts).tolist())
        self.last_counts = np.asarray(counts)
        return self._assemble(rows)

    def render_dynamic(self, camera, diff, verify: bool = False):
        """One sharded dispatch with the frame's SceneDiff folded into each
        shard's resident geometry (requires dynamic=True at construction).
        verify=True loops up to 8 grow-only refreezes until every count
        fits (see render(): with the hierarchical local cull a truncated
        top-level compaction makes finer-level counts undercounts)."""
        from distributed_raytracer.models.scene import SceneDiff

        if self._dyn is None:
            raise ValueError("build with dynamic=True for render_dynamic")
        cam = camera.to_arrays() if isinstance(camera, Camera) else camera
        diff = SceneDiff(*(jnp.asarray(a, jnp.float32) for a in diff))
        args = (cam, self.geom, self._perm, diff.light_pos, diff.light_col,
                self._dyn, diff)
        rows, counts = self._render_dyn_jit(*args)
        if verify:
            nl = len(self.loc_groups) + 1
            fits = False
            for _ in range(8):
                c = np.asarray(counts)
                if self.bounces:
                    worst = c.max(axis=0)        # (B+1, 2*nl)
                    if all(int(worst[b, k]) <= (self.w_pads[b] +
                                                self.w_pads_sh[b])[k]
                           for b in range(self.bounces + 1)
                           for k in range(2 * nl)):
                        fits = True
                        break
                    self._freeze_bounced(c.transpose(1, 0, 2))
                else:
                    pads_vec = self.w_pads + self.w_pads_sh
                    if all(int(c[:, k].max()) <= pads_vec[k]
                           for k in range(len(pads_vec))):
                        fits = True
                        break
                    self._freeze(c)
                rows, counts = self._render_dyn_jit(*args)
            if not fits:
                _log.warning(
                    "halo render_dynamic verify did not converge in 8 "
                    "rounds (counts %s); image may drop blocks",
                    np.asarray(counts).tolist())
        self.last_counts = np.asarray(counts)
        return self._assemble(rows)

    def scheduled_pairs(self) -> int:
        """Total (ray, triangle) pairs the last frame scheduled across all
        shards (primary/reflection nearest queries only) — the
        work-reduction diagnostic the dense sharded paths cannot offer
        (they always do rays x T/N per shard)."""
        c = self.last_counts
        fin = len(self.loc_groups)          # finest primary level column
        cells = (c[:, :, fin].sum() if c.ndim == 3    # bounced layout
                 else c[:, fin].sum())
        return int(cells) * self.rt * self.tb
