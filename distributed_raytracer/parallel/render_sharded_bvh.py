"""Multi-chip block-sparse rendering: the production scaling path.

Combines parallel/render_sharded.py's static row partition (the master's
tile dispatch analog) with ops/render_bvh.py's block-sparse pipeline: each
device owns a horizontal band of the frame and runs the full cull + BSR
traversal + shadow + shade pipeline on its own rays, with geometry
replicated (registrar.go:41-47's scene replication analog). No collectives
in the frame computation — scaling is bounded by the final framebuffer
gather, exactly like the reference's tile reassembly.

Work-list buckets must be static under shard_map (no host syncs inside a
traced computation), so they are sized by a per-band sizing pass on one
device at build time, maxed across bands and padded by `margin`. Every
frame ALSO returns its true per-band counts; render(cam, verify=True)
checks them against the frozen buckets and re-sizes + re-renders on
overflow — without this a camera outside the sizing margin would silently
drop candidate blocks, and the reference never displays a wrong tile
(master/main.go:153-161).
"""

from __future__ import annotations

import functools
import logging
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

_log = logging.getLogger(__name__)

try:
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

from distributed_raytracer.models.camera import Camera, CameraArrays
from distributed_raytracer.models.scene import Scene
from distributed_raytracer.ops.render_bvh import (CulledRenderer,
                                                      _bucket, _tile_bucket)
from distributed_raytracer.utils.config import RenderConfig, DEFAULT_CONFIG

AXIS = "bands"


def _make_band(scene: Scene, width: int, height: int, mesh: Optional[Mesh],
               cfg: RenderConfig):
    """Shared band setup: mesh, band-height renderer, per-band sizing walk.

    Returns (mesh, n, h_band, band, size_bands) where size_bands(measure)
    runs `measure(band)` once per band with the band's ray permutation
    installed and returns the list of results — the sizing-pass skeleton
    both renderer builders share.
    """
    if mesh is None:
        mesh = jax.make_mesh((len(jax.devices()),), (AXIS,))
    n = mesh.devices.size
    h_band = -(-height // n)

    band = CulledRenderer(scene, width, h_band, cfg=cfg)
    band.raygen_height = height  # bands project with the full frame's fov

    def size_bands(measure: Callable):
        base_perm = np.asarray(band._perm)
        out = []
        for b in range(n):
            band._perm = jax.device_put(
                jnp.asarray(np.minimum(base_perm + b * h_band * width,
                                       width * height - 1)))
            out.append(measure(band))
        band._perm = jax.device_put(jnp.asarray(base_perm))
        return out

    return mesh, n, h_band, band, size_bands


def _band_perm(perm, me, h_band, width, height):
    return jnp.minimum(perm + me * (h_band * width), width * height - 1)


def _finish(mesh, n, h_band, band, shard_fn, height, refreeze):
    """Common tail: shard_map wiring + the verify/render wrappers.

    shard_fn(cam) -> (band image, counts row); counts stack to (n, K).
    refreeze(counts (n, K)) rebuilds the jit with bigger buckets; it
    returns the new shard_fn (state lives in the closure of the caller).
    """
    state = {"fn": shard_fn}

    def build(fn):
        sharded = shard_map(
            fn, mesh=mesh,
            in_specs=(P(),) * 8,
            out_specs=(P(AXIS), P(AXIS)),
            # Pallas out_shapes carry no varying-mesh-axes annotation; the
            # traversal touches no collectives, so skip the vma typecheck.
            check_vma=False,
        )
        return jax.jit(sharded)

    state["jit"] = build(shard_fn)

    def device_fn(cam: CameraArrays):
        return state["jit"](band.arrays, band.tris_packed,
                            band.lights_scal, band.shade_tbl,
                            band.block_lo, band.block_hi, band._perm, cam)

    def render(cam, verify: bool = False) -> np.ndarray:
        c = cam.to_arrays() if isinstance(cam, Camera) else cam
        out, counts = device_fn(c)
        if verify:
            # Loop until every band's counts fit: a level-1 overflow makes
            # the reported level-2 counts undercounts, so a single
            # refreeze-from-reported-values could still truncate (see
            # CulledRenderer.render_fast's verify loop).
            fits = False
            for _ in range(8):
                new_fn = refreeze(np.asarray(counts))
                if new_fn is None:
                    fits = True
                    break
                state["jit"] = build(new_fn)
                out, counts = device_fn(c)
            if not fits:
                _log.warning(
                    "sharded verify did not converge in 8 rounds (counts "
                    "%s); image may drop blocks", np.asarray(counts).tolist())
        render.last_counts = np.asarray(counts)
        return np.asarray(out)[:height]          # (height_padded, W, 3)

    render.device_fn = device_fn
    render.band = band
    render.last_counts = None
    return render


def make_sharded_culled_renderer(scene: Scene, width: int, height: int,
                                 mesh: Optional[Mesh] = None,
                                 sizing_camera: Optional[Camera] = None,
                                 margin: float = 2.0,
                                 cfg: RenderConfig = DEFAULT_CONFIG,
                                 balance: bool = False):
    """Build a (cam) -> (H, W, 3) numpy renderer sharded over `mesh`.

    Returns the render function; `.device_fn` gives the still-sharded
    (image, counts) device outputs for perf measurement without the host
    gather; render(cam, verify=True) re-sizes buckets on overflow.

    balance=True uses cost-balanced band heights instead of equal ones
    (the least-loaded-scheduler analog — see
    make_balanced_culled_renderer).
    """
    if balance:
        return make_balanced_culled_renderer(
            scene, width, height, mesh=mesh, sizing_camera=sizing_camera,
            margin=margin, cfg=cfg)
    mesh, n, h_band, band, size_bands = _make_band(
        scene, width, height, mesh, cfg)
    camera = sizing_camera if sizing_camera is not None else scene.camera

    def measure(b):
        b.render(camera, block=True)
        return b._last_counts               # (c1, c2, sc1, sc2)

    counts = size_bands(measure)
    n_counts = len(counts[0])     # per-level primary, hit tiles, shadow
    hi = band._ht_idx             # the band's hit-TILE bucket slot
    pads0 = tuple(_bucket(max(c[k] for c in counts), margin)
                  for k in range(n_counts))
    ht = max(c[hi] for c in counts)
    buckets = {"pads": pads0[:hi]
               + (_tile_bucket(int(ht * margin), band.n_tiles),)
               + pads0[hi + 1:]}

    def make_fn(pads):
        def shard_fn(scene_arrays, tris_packed, lights_scal,
                     shade_tbl, block_lo, block_hi, perm, cam: CameraArrays):
            me = jax.lax.axis_index(AXIS)
            my_perm = _band_perm(perm, me, h_band, width, height)
            img, counts = band._full_fn(
                pads, scene_arrays, tris_packed,
                lights_scal, shade_tbl, block_lo, block_hi, my_perm, cam)
            return img, counts[None]            # (h_band, W, 3), (1, n_counts)
        return shard_fn

    def refreeze(got):                          # got: (n, n_counts)
        worst = got.max(axis=0)
        if all(int(worst[k]) <= buckets["pads"][k]
               for k in range(n_counts)):
            return None
        new = [max(p, _bucket(int(w), margin))
               for p, w in zip(buckets["pads"], worst)]
        new[hi] = max(buckets["pads"][hi],
                      _tile_bucket(int(worst[hi] * margin), band.n_tiles))
        buckets["pads"] = tuple(new)
        return make_fn(buckets["pads"])

    render = _finish(mesh, n, h_band, band,
                     make_fn(buckets["pads"]), height, refreeze)
    render.buckets = lambda: buckets["pads"]
    return render


def make_balanced_culled_renderer(scene: Scene, width: int, height: int,
                                  mesh: Optional[Mesh] = None,
                                  sizing_camera: Optional[Camera] = None,
                                  margin: float = 2.0,
                                  cfg: RenderConfig = DEFAULT_CONFIG,
                                  cap_factor: int = 2):
    """COST-balanced band heights: the least-loaded-scheduler analog.

    The reference assigns tiles to the least-loaded worker per order
    (master/pool/pool.go:148-197) because worker throughput varies. Chips
    are homogeneous, but WORK per band is not: the band covering the model
    schedules far more (ray-tile, tri-block) pairs than sky bands, and the
    equal-height split's wall time is bounded by the heaviest band. Here
    the split is balanced on measured cost instead:

      1. probe the full frame's per-tile fine cull cells
         (CulledRenderer.per_tile_cells) and sum them per tile ROW
         (tile_h=16 pixel rows, the partition granularity);
      2. partition rows into n contiguous bands minimizing the max band
         cost (parallel/tile.balanced_rows), each band capped at
         cap_factor x the equal share so the static band height (and
         per-device ray memory) stays bounded;
      3. every device renders the same STATIC padded height (SPMD needs
         equal shapes); tiles past a band's real rows carry a dead live
         mask and cull to zero work (ops/cull.tile_intervals_packed), so
         padding costs ~nothing.

    Work assignment must be static per compile under SPMD, so the balance
    is struck at build time from the sizing camera and refreshed
    explicitly: `render.rebalance(camera)` re-probes costs and updates the
    per-device row offsets WITHOUT recompiling (they are jit arguments);
    bucket overflow after a rebalance is caught by the usual verify loop.
    Images are bit-identical to the equal split (only the row->device
    assignment changes).
    """
    if mesh is None:
        mesh = jax.make_mesh((len(jax.devices()),), (AXIS,))
    n = int(mesh.devices.size)
    camera = sizing_camera if sizing_camera is not None else scene.camera
    from distributed_raytracer.parallel import tile as tile_mod

    # Band height cap in tile rows: cap_factor x the equal share.
    probe_tile_h = 512 // 32                  # CulledRenderer defaults
    ty_full = -(-height // probe_tile_h)
    rows_eq = -(-ty_full // n)
    cap = min(ty_full, cap_factor * rows_eq)

    band = CulledRenderer(scene, width, cap * probe_tile_h, cfg=cfg)
    band.raygen_height = height              # project with the full fov
    tx = -(-width // band.tile_w)
    slot_row_np = (np.arange(band.n_pad) // band.rt) // tx
    base_perm = np.asarray(band._perm)

    def probe_costs(cam) -> np.ndarray:
        """(ty_full,) per-tile-row fine cull cells for `cam`."""
        out = []
        for j in range(-(-ty_full // cap)):
            offs = j * cap * band.tile_h * width
            band._perm = jax.device_put(jnp.asarray(
                np.minimum(base_perm + offs, width * height - 1)))
            rows_here = min(cap, ty_full - j * cap)
            band._live = jax.device_put(jnp.asarray(slot_row_np < rows_here))
            per_tile = band.per_tile_cells(cam)
            out.append(per_tile.reshape(cap, tx).sum(axis=1)[:rows_here])
        band._live = None
        band._perm = jax.device_put(jnp.asarray(base_perm))
        return np.concatenate(out)

    def layout_for(cam):
        starts, rows = tile_mod.balanced_rows(probe_costs(cam), n, cap)
        return (np.asarray(starts, np.int32), np.asarray(rows, np.int32))

    starts_np, rows_np = layout_for(camera)

    # Bucket sizing: one sync render per band with its balanced rows.
    def size_bands(starts, rows):
        counts = []
        for b in range(n):
            band._perm = jax.device_put(jnp.asarray(np.minimum(
                base_perm + int(starts[b]) * band.tile_h * width,
                width * height - 1)))
            band._live = jax.device_put(
                jnp.asarray(slot_row_np < int(rows[b])))
            band.render(camera, block=True)
            counts.append(band._last_counts)
        band._live = None
        band._perm = jax.device_put(jnp.asarray(base_perm))
        return counts

    counts = size_bands(starts_np, rows_np)
    n_counts = len(counts[0])
    hi = band._ht_idx
    pads0 = tuple(_bucket(max(c[k] for c in counts), margin)
                  for k in range(n_counts))
    ht = max(c[hi] for c in counts)
    buckets = {"pads": pads0[:hi]
               + (_tile_bucket(int(ht * margin), band.n_tiles),)
               + pads0[hi + 1:]}

    state = {
        "row_start": jax.device_put(jnp.asarray(starts_np)),
        "rows": jax.device_put(jnp.asarray(rows_np)),
        "rows_host": rows_np,
    }

    def make_fn(pads):
        def shard_fn(scene_arrays, tris_packed, lights_scal,
                     shade_tbl, block_lo, block_hi, perm, row_start, rows,
                     cam: CameraArrays):
            me = jax.lax.axis_index(AXIS)
            my_perm = jnp.minimum(
                perm + row_start[me] * (band.tile_h * width),
                width * height - 1)
            slot_row = (jnp.arange(band.n_pad, dtype=jnp.int32)
                        // band.rt) // tx
            live = slot_row < rows[me]
            img, cts = band._full_fn(
                pads, scene_arrays, tris_packed, lights_scal,
                shade_tbl, block_lo, block_hi, my_perm, cam, live)
            return img, cts[None]
        return shard_fn

    def build(fn):
        sharded = shard_map(
            fn, mesh=mesh,
            in_specs=(P(),) * 10,
            out_specs=(P(AXIS), P(AXIS)),
            check_vma=False,
        )
        return jax.jit(sharded)

    jit_state = {"jit": build(make_fn(buckets["pads"]))}

    def refreeze(got):                        # got: (n, n_counts)
        worst = got.max(axis=0)
        if all(int(worst[k]) <= buckets["pads"][k] for k in range(n_counts)):
            return None
        new = [max(p, _bucket(int(w), margin))
               for p, w in zip(buckets["pads"], worst)]
        new[hi] = max(buckets["pads"][hi],
                      _tile_bucket(int(worst[hi] * margin), band.n_tiles))
        buckets["pads"] = tuple(new)
        return make_fn(buckets["pads"])

    def device_fn(cam: CameraArrays):
        return jit_state["jit"](
            band.arrays, band.tris_packed, band.lights_scal,
            band.shade_tbl, band.block_lo, band.block_hi, band._perm,
            state["row_start"], state["rows"], cam)

    band_h = cap * band.tile_h

    def render(cam, verify: bool = False) -> np.ndarray:
        c = cam.to_arrays() if isinstance(cam, Camera) else cam
        out, counts = device_fn(c)
        if verify:
            fits = False
            for _ in range(8):
                new_fn = refreeze(np.asarray(counts))
                if new_fn is None:
                    fits = True
                    break
                jit_state["jit"] = build(new_fn)
                out, counts = device_fn(c)
            if not fits:
                _log.warning(
                    "balanced verify did not converge in 8 rounds (counts "
                    "%s); image may drop blocks", np.asarray(counts).tolist())
        render.last_counts = np.asarray(counts)
        img = np.asarray(out).reshape(n, band_h, width, 3)
        rows = state["rows_host"]
        parts = [img[b, :int(rows[b]) * band.tile_h] for b in range(n)]
        return np.concatenate(parts, axis=0)[:height]

    def rebalance(cam) -> None:
        """Re-probe costs and update the row->device assignment for the
        current viewpoint WITHOUT recompiling (offsets are jit arguments).
        The heartbeat-driven re-assignment analog of pool.go's per-order
        least-loaded pick, at explicit (caller-chosen) cadence."""
        starts2, rows2 = layout_for(cam)
        state["row_start"] = jax.device_put(jnp.asarray(starts2))
        state["rows"] = jax.device_put(jnp.asarray(rows2))
        state["rows_host"] = rows2

    render.device_fn = device_fn
    render.band = band
    render.last_counts = None
    render.buckets = lambda: buckets["pads"]
    render.layout = lambda: (np.asarray(state["row_start"]),
                             state["rows_host"])
    render.rebalance = rebalance
    return render


def make_sharded_bounced_renderer(scene: Scene, width: int, height: int,
                                  depth: int, mesh: Optional[Mesh] = None,
                                  sizing_camera: Optional[Camera] = None,
                                  margin: float = 2.0,
                                  cfg: RenderConfig = DEFAULT_CONFIG):
    """Multi-chip Whitted multi-bounce rendering (the sharded sibling of
    CulledRenderer.freeze_bounced — BASELINE config 2 at scale).

    Same band decomposition as make_sharded_culled_renderer; per-bounce
    work-list buckets are sized from each band's RAW sync-render counts
    (never from already-rounded pads) and verified per frame like the
    culled variant. Reflection rays stay within their band's pipeline —
    geometry is replicated, so no cross-band exchange is needed (the
    geometry-sharded secondary-ray schedules are parallel/halo_bvh.py and
    parallel/ring_bvh.py).
    """
    mesh, n, h_band, band, size_bands = _make_band(
        scene, width, height, mesh, cfg)
    camera = sizing_camera if sizing_camera is not None else scene.camera

    def measure(b):
        b.render_bounced(camera, depth, block=True)
        return b._last_bounce_counts

    per_band = size_bands(measure)
    n_per = len(per_band[0][0])     # 2*n_levels + 1 counts per bounce
    hi = band._ht_idx               # the hit-tile slot inside each bounce
    raw = tuple(tuple(max(band_counts[k][j] for band_counts in per_band)
                      for j in range(n_per)) for k in range(depth + 1))

    def quad_pads(quad):
        return tuple(_tile_bucket(int(x * margin), band.n_tiles)
                     if j == hi else _bucket(x, margin)
                     for j, x in enumerate(quad))

    state = {"pads": tuple(quad_pads(quad) for quad in raw)}

    def make_fn(pads):
        def shard_fn(scene_arrays, tris_packed, lights_scal,
                     shade_tbl, block_lo, block_hi, perm, cam: CameraArrays):
            me = jax.lax.axis_index(AXIS)
            my_perm = _band_perm(perm, me, h_band, width, height)
            img, counts = band._full_bounced_fn(
                pads, scene_arrays, tris_packed, lights_scal,
                shade_tbl, block_lo, block_hi, my_perm, cam)
            return img, counts[None]   # (h_band, W, 3), (1, B, 2*n_levels)
        return shard_fn

    def refreeze(got):                          # got: (n, B, 2*n_levels)
        worst = got.max(axis=0)
        if all(int(worst[k, j]) <= state["pads"][k][j]
               for k in range(depth + 1) for j in range(n_per)):
            return None
        state["pads"] = tuple(
            tuple(max(p, q) for p, q in zip(quad, quad_pads(worst_quad)))
            for quad, worst_quad in zip(state["pads"], worst))
        return make_fn(state["pads"])

    render = _finish(mesh, n, h_band, band, make_fn(state["pads"]), height,
                     refreeze)
    render.buckets = lambda: state["pads"]
    return render
