"""Block-BVH-culled ring rendering: geometry rotation with per-step
hierarchical culling.

parallel/ring.py rotates triangle shards past resident rays with dense
matmuls — every resident ray against every rotating triangle, O(rays x T)
per device per frame. This module keeps the ring schedule (the
ring-attention analog: geometry blocks stream past pinned queries, nearest
hit folds as an online associative min) but culls each rotation step with
the MULTILEVEL interval walk (ops/cull.py multilevel_mask/worklist — the
same per-shard hierarchy the halo schedule runs) and runs only surviving
(tile, block) pairs through the Pallas BSR kernels — pruning on *every*
query at *every* level, like the reference's R-trees
(/root/reference/shared/state/mesh.go:139, object.go:76, tracer.go:32).

Schedule per device (r_loc resident rays, T/N rotating triangles), one
iteration per bounce (bounces=0 is a single iteration):
  phase 1 — N ring steps: hierarchical cull of resident ray tiles vs the
    CURRENT shard's local block hierarchy -> leaf work list -> BSR nearest
    seeded with the carried (t, gid) accumulator (the kernels' min-gid
    tie-break makes the fold order-independent); gather the 32-wide shading
    row from the current shard's table where the candidate improved;
    ppermute the shard on. After N steps geometry is home again.
  phase 2 — shadow: reversed per-light queries (light -> surface point) for
    resident rays; N more ring steps of hierarchical cull -> BSR any-hit
    with the carried occlusion bits. Tile hulls are computed ONCE per phase
    (queries are fixed during a rotation); only the masks vs the rotating
    block AABBs change per step.
  shade — local Phong from the carried rows (shade.shade_core_rows);
    radiance accumulates as colour += throughput * phong_b exactly as the
    replicated ops/render_bvh.render_bounced.
  next bounce — resident reflection rays from the carried shading rows
    (halo_bvh.reflect_rows). Unlike the halo schedule, reflection rays STAY
    RESIDENT — the ring never moves rays, so a bounce costs no all_gather:
    the next rotation streams geometry past the new resident query set with
    per-ray origins. Dead rays (miss / zero-Ks) are masked out of the tile
    hulls so they cull to zero work at every step.

vs the halo schedule (parallel/halo_bvh.py): the ring moves GEOMETRY
(O(T/N x 50 f32) per step per device, N steps) and never moves rays; the
halo moves RAYS (O(rays) per bounce) and never moves geometry. Halo wins
when rays << triangles (config 5); the ring wins when a frame's rays
outnumber resident triangles or when ray payloads are fat (many bounces,
which here are comm-free). Both must render identical images (the fold is
exact).

Work-list buckets are static under shard_map; sized at build time from the
full-scene cull masks maxed over (ray-shard, geometry-shard) pairs — each
device meets every geometry shard during rotation, so the max over pairs
bounds every step. Per-level bucket exactness: the interval test against a
union (parent) box is conservative, so a member box that passes also has a
passing parent — the flat member-level mask restricted to a (ray, geom)
pair therefore counts EXACTLY that pair's expansion survivors, and
per-level per-pair mask counts are exact bucket-sizing inputs.
"""

from __future__ import annotations

import functools
import logging
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

try:
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

from distributed_raytracer.models.camera import Camera, CameraArrays
from distributed_raytracer.models.scene import Scene
from distributed_raytracer.ops import cull, raygen, shade
from distributed_raytracer.ops.pallas import bsr_trace
from distributed_raytracer.parallel.halo_bvh import (
    DynGeometry, ShardedGeometry, _pad_to_shardable, apply_diff_sharded,
    reflect_rows)
from distributed_raytracer.utils.config import RenderConfig, DEFAULT_CONFIG

_log = logging.getLogger(__name__)

AXIS = "ring"
_bucket = bsr_trace.bucket_w_pad


def _rotate(tree, n: int):
    perm = [(i, (i + 1) % n) for i in range(n)]
    return jax.tree.map(lambda a: jax.lax.ppermute(a, AXIS, perm), tree)


class RingCulledRenderer:
    """Geometry-rotation renderer with per-step hierarchical BVH culling.

    Same bucket discipline as HaloCulledRenderer: static work lists sized
    from `sizing_camera` x `margin`; render(cam, verify=True) loops
    grow-only re-sizes (up to 8) until every reported count fits, instead
    of dropping candidate blocks.
    """

    def __init__(self, scene: Scene, width: int, height: int,
                 mesh: Optional[Mesh] = None,
                 sizing_camera: Optional[Camera] = None,
                 margin: float = 2.0, cfg: RenderConfig = DEFAULT_CONFIG,
                 block_size: int = 128, ray_tile: int = 512,
                 dynamic: bool = False,
                 bounces: int = 0, local_levels: Optional[int] = None,
                 local_group: int = 16, tile_w: Optional[int] = None):
        if mesh is None:
            mesh = jax.make_mesh((len(jax.devices()),), (AXIS,))
        self.mesh = mesh
        self.n = int(mesh.devices.size)
        self.bounces = int(bounces)
        self.width, self.height, self.cfg = width, height, cfg
        self.rt, self.tb = ray_tile, block_size
        self.margin = margin

        # dynamic=True: per-object grouped bake for exact per-frame AABB
        # shifts under SceneDiff (render_dynamic below). Orthogonal to
        # bounces — the diff folds into the resident shard BEFORE the first
        # rotation, so every step of every bounce streams updated geometry.
        if dynamic:
            (arrays, tree, obj_id, block_obj,
             obj_pos0) = scene.bake_bvh_grouped(block_size=block_size)
        else:
            arrays, tree = scene.bake_bvh(block_size=block_size)
        nb_orig = tree.num_blocks
        # Per-step cull hierarchy over the ROTATING shard's blocks: above
        # ~1024 resident blocks the flat (tiles x blocks) mask + compaction
        # argsort dominates each step, so local superblock levels are added
        # (groups never straddle shards — the block padding aligns to it).
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
        self._full = (jnp.asarray(tris16), jnp.asarray(table32),
                      jnp.asarray(lo), jnp.asarray(hi))

        # 2D screen-tile ray layout. `tile_w` overrides the aspect —
        # squarer tiles (16x16 at ray_tile=256) have tighter interval hulls
        # per ray, which cuts scheduled pairs on surface-heavy scenes (the
        # config-5 A/B result, tools/config5_ab.py) at the cost of more
        # tiles.
        self.tile_w = 32 if tile_w is None else tile_w
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
        self.nt_loc = self.r_loc // ray_tile
        self._perm = jax.device_put(jnp.asarray(perm), sh(P()))

        camera = sizing_camera if sizing_camera is not None else scene.camera
        counts = self._sizing_counts(camera)     # (B+1, 2*nl)
        self._freeze(counts)
        self._full = None
        self.last_counts = counts

    # -- sizing (build time, one device, full geometry) ---------------------
    #
    # Every device meets every geometry shard during rotation, so the
    # per-step work at any level for (ray-shard d, step k) is exactly the
    # full-scene level mask restricted to d's tile rows and shard (d+k)'s
    # block columns (shard-aligned grouping: the block padding guarantees
    # local groups never straddle shards, so global level-k boxes restricted
    # to a shard's columns ARE that shard's local level-k boxes). The max
    # over all (d, s) pairs therefore bounds every step of every device.

    def _per_pair(self, mask, nbl: int):
        """(nt_ext, n*nbl) mask -> (n, n) kept cells per (ray, geom) pair."""
        nt = mask.shape[0]
        return mask.reshape(self.n, nt // self.n, self.n,
                            nbl).sum(axis=(1, 3))

    def _pair_levels(self, ti, blo, bhi):
        """(nl, n, n) per-pair kept cells at every LOCAL cull level,
        coarsest first (exact expansion counts — see module docstring)."""
        rows = []
        for lo, hi in reversed(cull.level_bounds(blo, bhi, self.loc_groups)):
            m, _ = cull.block_mask_with_entry(ti, lo, hi)
            rows.append(self._per_pair(m, lo.shape[0] // self.n))
        return jnp.stack(rows)

    def _size_step(self, shared: bool, w_full: int, tris16, table32, blo,
                   bhi, rays, live, excl, view):
        """One bounce of the sizing walk on full geometry: per-level
        per-pair primary counts, the full nearest (flat work list), shadow
        counts, and the next bounce's ray state."""
        ti = cull.tile_intervals_packed(rays, self.rt, live=live)
        p_levels = self._pair_levels(ti, blo, bhi)         # (nl, n, n)
        mask, entry = cull.block_mask_with_entry(ti, blo, bhi)
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
            per_ls.append(self._pair_levels(ti_s, blo, bhi))
        s_levels = (jnp.stack(per_ls) if per_ls
                    else jnp.zeros((0, nl, self.n, self.n), jnp.int32))
        r_rays, live2 = reflect_rows(self.cfg, prep, rays, valid)
        excl2 = jnp.where(valid, bi, -1)
        return p_levels, s_levels, r_rays, live2, excl2, prep.x

    def _sizing_counts(self, camera) -> np.ndarray:
        """(B+1, 2*nl) int: per-bounce per-LOCAL-level max-over-pairs
        (primary cells then max-per-light shadow cells, coarsest..finest) —
        the bucket-sizing inputs."""
        cam = camera.to_arrays() if isinstance(camera, Camera) else camera
        tris16, table32, blo, bhi = self._full
        d_rows = raygen.ray_rows_flat(cam, self.width, self.height,
                                      self._perm)
        rays = bsr_trace.pack_rays_rows(cam.pos, d_rows)
        live = jnp.ones((self.n_pad_ext,), bool)
        excl = jnp.full((self.n_pad_ext,), -1, jnp.int32)
        view = cam.pos
        nl = len(self.loc_groups) + 1

        def flat_count(rays, live):
            ti = cull.tile_intervals_packed(rays, self.rt, live=live)
            mask, _ = cull.block_mask_with_entry(ti, blo, bhi)
            return mask.sum().astype(jnp.int32)

        count_fn = jax.jit(flat_count)
        out = []
        for b in range(self.bounces + 1):
            w_full = _bucket(int(count_fn(rays, live)))
            step = jax.jit(functools.partial(self._size_step, b == 0,
                                             w_full))
            p_levels, s_levels, rays, live, excl, view = step(
                tris16, table32, blo, bhi, rays, live, excl, view)
            p_max = np.asarray(p_levels).max(axis=(1, 2))    # (nl,)
            s_np = np.asarray(s_levels)
            s_max = (s_np.max(axis=(0, 2, 3)) if s_np.size
                     else np.zeros((nl,), np.int64))
            out.append(np.concatenate([p_max, s_max]))       # (2*nl,)
        return np.stack(out)

    # -- the sharded frame ---------------------------------------------------

    def _shard_fn(self, w_pads: tuple, w_pads_sh: tuple, cam: CameraArrays,
                  geom: ShardedGeometry, perm, lights_pos, lights_col,
                  dyn=None, diff=None):
        """One device's frame: bounces+1 iterations of (nearest rotation,
        shadow rotation, shade). w_pads/w_pads_sh are per-bounce tuples of
        per-level buckets."""
        n, rt, tb = self.n, self.rt, self.tb
        nl = len(self.loc_groups) + 1
        if diff is not None:
            # Fold the frame's diff into the resident shard BEFORE the
            # rotation starts: every shard holds diffed rows, so every
            # rotation step streams already-updated geometry
            # (environment.go:73-98's every-worker-applies-every-diff).
            geom = apply_diff_sharded(geom, dyn, diff)
        me = jax.lax.axis_index(AXIS)

        # Resident rays: this device's contiguous run of screen tiles.
        idx = jax.lax.dynamic_slice(perm, (me * self.r_loc,), (self.r_loc,))
        d_rows = raygen.ray_rows_flat(cam, self.width, self.height, idx)
        rays = bsr_trace.pack_rays_rows(cam.pos, d_rows)    # (8, r_loc)
        live = jnp.ones((self.r_loc,), bool)
        excl = jnp.full((self.r_loc,), -1, jnp.int32)
        colour = jnp.zeros((3, self.r_loc), jnp.float32)
        throughput = jnp.ones((3, self.r_loc), jnp.float32)
        view = cam.pos
        counts = []

        for b in range(self.bounces + 1):
            pads_b, pads_sh_b = w_pads[b], w_pads_sh[b]
            ti = cull.tile_intervals_packed(rays, rt, live=live)

            # Phase 1: rotate geometry N times, folding culled nearest
            # hits through the multilevel walk vs the CURRENT shard.
            init = (
                jnp.full((self.r_loc,), jnp.inf, jnp.float32),         # t
                jnp.full((self.r_loc,), bsr_trace.BIG_IDX, jnp.int32),
                jnp.zeros((self.r_loc, 32), jnp.float32),              # rows
                jnp.zeros((nl,), jnp.int32),                  # level maxes
                jnp.int32(0),                                 # fine-cell sum
            )

            def step1(carry, _):
                (bt, bi, g, cvec, csum), sh = carry
                mask, entry, c_top = cull.multilevel_mask(
                    ti, sh.block_lo, sh.block_hi, self.loc_groups)
                wl, exp = cull.multilevel_worklist(
                    ti, mask, entry, c_top, sh.block_lo, sh.block_hi,
                    self.loc_groups, pads_b)
                lv = jnp.stack([c_top.astype(jnp.int32)]
                               + [c.astype(jnp.int32) for c in exp])
                cvec = jnp.maximum(cvec, lv)
                csum = csum + lv[-1]
                if b == 0:
                    tris_arg = bsr_trace.pack_tris_origin(sh.tris16, cam.pos)
                else:
                    tris_arg = sh.tris16        # per-ray origins
                nt, ni = bsr_trace.bsr_nearest(
                    rays, excl, tris_arg, wl.tile_ids, wl.block_ids,
                    wl.count, init_t=bt, init_i=bi,
                    gid_base=sh.base[0], rt=rt, tb=tb, shared_origin=(b == 0))
                visited = jnp.repeat(
                    cull.visited_tiles(wl, self.nt_loc), rt)
                nt = jnp.where(visited, nt, bt)
                ni = jnp.where(visited, ni, bi)
                improved = (nt < bt) | ((nt == bt) & (ni < bi))
                loc = jnp.clip(ni - sh.base[0], 0, sh.tris16.shape[0] - 1)
                g = jnp.where(improved[:, None], sh.table32[loc], g)
                return ((nt, ni, g, cvec, csum), _rotate(sh, n)), None

            ((best_t, best_i, best_g, cvec_p, csum_p), geom), _ = \
                jax.lax.scan(step1, (init, geom), None, length=n)
            valid = jnp.isfinite(best_t) & live

            # Phase 2: shadow rotation. Queries fixed; hulls computed once.
            prep = shade.prepare_packed_rows(
                lights_pos, rays, jnp.where(valid, best_t, 0.0),
                best_g.T, self.cfg)
            live_l = shade.light_gates_rows(lights_col, view, prep, valid)
            excl_sh = jnp.where(valid, best_i, -1)
            tis = [cull.tile_intervals_packed(prep.q_rev[li], rt,
                                              live=live_l[li], use_tmax=True)
                   for li in range(self.n_lights)]

            def step2(carry, _):
                (hit, cvec, csum), sh = carry
                new = []
                for li in range(self.n_lights):
                    smask, sentry, sc_top = cull.multilevel_mask(
                        tis[li], sh.block_lo, sh.block_hi, self.loc_groups)
                    swl, s_exp = cull.multilevel_worklist(
                        tis[li], smask, sentry, sc_top, sh.block_lo,
                        sh.block_hi, self.loc_groups, pads_sh_b)
                    lv = jnp.stack([sc_top.astype(jnp.int32)]
                                   + [c.astype(jnp.int32) for c in s_exp])
                    cvec = jnp.maximum(cvec, lv)
                    csum = csum + lv[-1]
                    tris_l = bsr_trace.pack_tris_origin(sh.tris16,
                                                        lights_pos[li])
                    h = bsr_trace.bsr_any(
                        prep.q_rev[li], excl_sh, tris_l, swl.tile_ids,
                        swl.block_ids, swl.count, init=hit[li],
                        gid_base=sh.base[0], rt=rt, tb=tb,
                        shared_origin=True)
                    s_vis = jnp.repeat(
                        cull.visited_tiles(swl, self.nt_loc), rt)
                    new.append(jnp.where(s_vis, h, hit[li]))
                hit = jnp.stack(new) if new else hit
                return ((hit, cvec, csum), _rotate(sh, n)), None

            hit0 = jnp.zeros((self.n_lights, self.r_loc), jnp.int32)
            ((hit, cvec_s, csum_s), geom), _ = jax.lax.scan(
                step2, ((hit0, jnp.zeros((nl,), jnp.int32), jnp.int32(0)),
                        geom), None, length=n)
            lit = hit == 0

            local = shade.shade_core_rows(lights_col, view, prep, valid,
                                          lit)
            colour = colour + throughput * local
            counts.append(jnp.concatenate(
                [cvec_p, cvec_s, csum_p[None], csum_s[None]]))
            if b == self.bounces:
                break
            throughput = jnp.where(valid[None, :],
                                   throughput * prep.ks, 0.0)
            # Next bounce: resident reflections (no comm — rays stay put).
            rays, live = reflect_rows(self.cfg, prep, rays, valid)
            excl = jnp.where(valid, best_i, -1)
            view = prep.x

        colour = jnp.clip(colour, 0.0, 1.0)
        return colour, jnp.stack(counts)[None]   # (3, r_loc), (1, B+1, 2nl+2)

    def _freeze(self, counts: np.ndarray) -> None:
        """Compile the pipeline with per-bounce per-level buckets from the
        (B+1, 2*nl) sizing counts x margin, grow-only across refreezes."""
        from distributed_raytracer.models.scene import SceneDiff

        counts = np.asarray(counts)
        if counts.ndim == 1:
            counts = counts[None, :]
        nl = len(self.loc_groups) + 1
        w_pads = tuple(tuple(_bucket(int(c), self.margin)
                             for c in counts[b, :nl])
                       for b in range(counts.shape[0]))
        w_pads_sh = tuple(tuple(_bucket(int(c), self.margin)
                                for c in counts[b, nl:2 * nl])
                          for b in range(counts.shape[0]))
        # Grow-only: the verify loop rebuilds from the latest reported
        # counts; without the max a bucket could oscillate and break the
        # each-round-strictly-grows convergence argument.
        prev = getattr(self, "w_pads", None)
        if prev is not None:
            w_pads = tuple(tuple(max(a, c) for a, c in zip(q, pq))
                           for q, pq in zip(w_pads, prev))
            w_pads_sh = tuple(tuple(max(a, c) for a, c in zip(q, pq))
                              for q, pq in zip(w_pads_sh, self.w_pads_sh))
        self.w_pads, self.w_pads_sh = w_pads, w_pads_sh
        # Finest-level aliases (diagnostics/tests).
        self.w_pad, self.w_pad_sh = w_pads[0][-1], w_pads_sh[0][-1]
        fn = functools.partial(self._shard_fn, w_pads, w_pads_sh)
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

    # -- public --------------------------------------------------------------

    def device_fn(self, cam: CameraArrays):
        return self._render_jit(cam, self.geom, self._perm,
                                self.lights_pos, self.lights_col)

    def _assemble(self, rows: jnp.ndarray) -> np.ndarray:
        tw, th = self.tile_w, self.tile_h
        tx, ty = -(-self.width // tw), -(-self.height // th)
        img = np.asarray(rows)[:, :self.n_pad]
        img = img.reshape(3, ty, tx, th, tw).transpose(1, 3, 2, 4, 0)
        img = img.reshape(ty * th, tx * tw, 3)
        return img[:self.height, :self.width]

    def _counts_fit(self, c: np.ndarray) -> bool:
        nl = len(self.loc_groups) + 1
        worst = c.max(axis=0)                     # (B+1, 2*nl + 2)
        return all(int(worst[b, k]) <= (self.w_pads[b]
                                        + self.w_pads_sh[b])[k]
                   for b in range(worst.shape[0])
                   for k in range(2 * nl))

    def _verify_loop(self, dispatch, rows, counts):
        """LOOP until every reported per-bounce per-level count fits its
        bucket (up to 8 grow-only refreezes): a truncated top-level
        compaction makes finer-level counts undercounts, and later bounces'
        ray sets derive from earlier (possibly truncated) nearest results —
        one refreeze from reported counts is not sufficient (mirrors
        CulledRenderer.render_fast's verify loop)."""
        fits = False
        for _ in range(8):
            c = np.asarray(counts)
            if self._counts_fit(c):
                fits = True
                break
            nl = len(self.loc_groups) + 1
            self._freeze(c.max(axis=0)[:, :2 * nl])
            rows, counts = dispatch()
        if not fits:
            _log.warning(
                "ring verify did not converge in 8 rounds (counts %s); "
                "image may drop blocks", np.asarray(counts).tolist())
        return rows, counts

    def render(self, camera, verify: bool = False) -> np.ndarray:
        cam = camera.to_arrays() if isinstance(camera, Camera) else camera
        rows, counts = self.device_fn(cam)
        if verify:
            rows, counts = self._verify_loop(
                lambda: self.device_fn(cam), rows, counts)
        self.last_counts = np.asarray(counts)
        return self._assemble(rows)

    def render_dynamic(self, camera, diff, verify: bool = False):
        """One sharded ring dispatch with the frame's SceneDiff folded
        into each shard before rotation (requires dynamic=True); composes
        with bounces=N (every rotation of every bounce streams the diffed
        geometry)."""
        from distributed_raytracer.models.scene import SceneDiff

        if self._dyn is None:
            raise ValueError("build with dynamic=True for render_dynamic")
        cam = camera.to_arrays() if isinstance(camera, Camera) else camera
        diff = SceneDiff(*(jnp.asarray(a, jnp.float32) for a in diff))
        args = (cam, self.geom, self._perm, diff.light_pos, diff.light_col,
                self._dyn, diff)
        rows, counts = self._render_dyn_jit(*args)
        if verify:
            rows, counts = self._verify_loop(
                lambda: self._render_dyn_jit(*args), rows, counts)
        self.last_counts = np.asarray(counts)
        return self._assemble(rows)

    def scheduled_pairs(self) -> int:
        """Total (ray, triangle) pairs the last frame's nearest queries
        scheduled across all shards, steps, and bounces (finest-level cull
        cells x rt x tb; shadow queries excluded, as
        HaloCulledRenderer.scheduled_pairs)."""
        c = self.last_counts
        nl = len(self.loc_groups) + 1
        return int(c[:, :, 2 * nl].sum()) * self.rt * self.tb
