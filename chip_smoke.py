"""On-card smoke test: the renderer's main path on one NVIDIA GPU.

    python chip_smoke.py               # one card, phases 1-5
    python chip_smoke.py --four-cards  # four cards: the multi-card schedules

Phases (one process; any failure exits non-zero before the result line):
  1. Traversal kernels (Triton) vs the plain-XLA traversal on real work
     lists — primary and shadow, culled from the config-5 frame — at
     tb 64/128, rt 256/512/1024, shared and per-ray origins, with and
     without a carried init and gid_base.
  2. Config 5: icosphere_scene(9) (5.24M triangles, 3 lights) at 640x480
     through CulledRenderer: sync render, freeze, then render_fast frames
     along an orbit (median / p90 frame time).
  3. Correctness: culled vs the dense renderer on icosphere_scene(5) at
     640x480; culled vs the float64 oracle on icosphere_scene(3).
  4. Bounces: freeze_bounced(depth=2) at 1920x1080 vs the dense bounced
     renderer (the per-ray-origin traversal).
  5. The CLI end to end (run.main) on a seeded procedural OBJ+JSON scene:
     a 4x4 grid of icosphere_mesh(6) instances, 1.31M triangles.
  --four-cards runs only: sharded-bvh bands (plain and balanced) at
  3840x2160, and the halo and ring schedules on icosphere_scene(9) at
  640x480, each against the single-card CulledRenderer image.

The last stdout line is the JSON result; earlier lines are the report.
Refuses to run (exit 2) when JAX's backend is not a GPU.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np

SMOKE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         ".smoke_scene")


def log(*parts) -> None:
    print(*parts, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)
    log(f"  ok: {what}")


def timed(fn, reps: int):
    """Per-call host-clock seconds of fn() ending in block_until_ready."""
    import jax

    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        out.append(time.perf_counter() - t0)
    return np.asarray(out)


# ---------------------------------------------------------------------------
# Phase 1: kernels vs the plain traversal
# ---------------------------------------------------------------------------

def frame_work_lists(r, cam):
    """(rays, primary work list, shadow bsr_any args) of one frame, using
    the renderer's frozen buckets (freeze() first)."""
    import jax

    from distributed_raytracer.ops import cull

    pads, nl = r._frozen_pads, r.n_levels

    @jax.jit
    def lists(arrays, tris_packed, lights_scal, shade_tbl, blo, bhi, perm,
              cam):
        rays, ti, m, e, c1 = r._stage_a_fn(cam, perm, blo, bhi)
        wl, _ = cull.multilevel_worklist(ti, m, e, c1, blo, bhi, r.groups,
                                         pads[:nl])
        hits, _, _ = r._stage_b1_fn(pads[:nl], arrays, tris_packed, blo, bhi,
                                    rays, ti, m, e, c1)
        (_, _, hits_h, prep, live_l, sti, smasks, sentries, sc1,
         _) = r._stage_b2_fn(pads[nl], arrays, shade_tbl, blo, bhi, rays,
                             hits)
        shadow, _ = r._shadow_query(pads[nl + 1:], lights_scal, blo, bhi,
                                    prep, hits_h, live_l, sti, smasks,
                                    sentries, sc1)
        return rays, (wl.tile_ids, wl.block_ids, wl.count), shadow

    return lists(r.arrays, r.tris_packed, r.lights_scal, r.shade_tbl,
                 r.block_lo, r.block_hi, r._perm, cam)


def split_blocks(tile_ids, block_ids, count):
    """The same work list over half-size blocks: item (t, b) becomes
    (t, 2b), (t, 2b + 1) — identical triangles, so identical results."""
    import jax.numpy as jnp

    pair = jnp.stack([2 * block_ids, 2 * block_ids + 1], axis=1).reshape(-1)
    return jnp.repeat(tile_ids, 2), pair, 2 * count


def compare_nearest(label, args, kw, init, gid_base):
    import jax

    from distributed_raytracer.ops.pallas import bsr_trace as bt

    fp = jax.jit(functools.partial(bt.nearest_pallas, **kw))
    fx = jax.jit(functools.partial(bt.nearest_xla, **kw))
    extra = (init[0], init[1], gid_base)
    ms_p = timed(lambda: fp(*args, *extra), 3).min() * 1e3
    ms_x = timed(lambda: fx(*args, *extra), 3).min() * 1e3
    pt, pi = map(np.asarray, fp(*args, *extra))
    xt, xi = map(np.asarray, fx(*args, *extra))
    # Second-best t per ray (the best id excluded): ids must agree where
    # the best t is unique to 1e-6.
    excl2 = jax.numpy.asarray(xi)
    t2, _ = fx(args[0], excl2, *args[2:], *extra)
    t2 = np.asarray(t2)
    hit = np.isfinite(xt)
    rel = (np.abs(pt[hit] - xt[hit]) / np.maximum(np.abs(xt[hit]), 1e-30)
           ).max(initial=0.0)
    with np.errstate(invalid="ignore"):
        unique = hit & ~(np.abs(t2 - xt) <= 1e-6 * np.abs(xt))
    bad_ids = int((pi[unique] != xi[unique]).sum())
    log(f"  {label}: hits {int(hit.sum())}, max t rel err {rel:.2e}, "
        f"id mismatches {bad_ids} of {int(unique.sum())} unique | "
        f"kernel {ms_p:.3f} ms, xla {ms_x:.3f} ms")
    check(np.array_equal(np.isfinite(pt), hit), f"{label}: hit masks equal")
    check(rel <= 1e-5, f"{label}: t rel err <= 1e-5")
    check(bad_ids == 0, f"{label}: ids equal where t is unique")
    return fp, extra


def compare_any(label, args, kw, init, gid_base):
    import jax

    from distributed_raytracer.ops.pallas import bsr_trace as bt

    fp = jax.jit(functools.partial(bt.any_pallas, **kw))
    fx = jax.jit(functools.partial(bt.any_xla, **kw))
    ms_p = timed(lambda: fp(*args, init, gid_base), 3).min() * 1e3
    ms_x = timed(lambda: fx(*args, init, gid_base), 3).min() * 1e3
    got = np.asarray(fp(*args, init, gid_base))
    want = np.asarray(fx(*args, init, gid_base))
    bad = int((got != want).sum())
    log(f"  {label}: occluded {int(want.sum())} of {want.size}, mismatches "
        f"{bad} | kernel {ms_p:.3f} ms, xla {ms_x:.3f} ms")
    check(bad == 0, f"{label}: any-hit flags equal")


def phase_kernels(renderers, cam):
    import jax
    import jax.numpy as jnp

    from distributed_raytracer.ops.pallas import bsr_trace as bt

    rng = np.random.default_rng(0)
    printed = False
    for r in renderers:
        rays, (tile_ids, block_ids, count), shadow = frame_work_lists(r, cam)
        n_ray = rays.shape[1]
        no_excl = jnp.full((n_ray,), -1, jnp.int32)
        tris_cam = bt.pack_tris_origin(r.tris_packed, cam.pos)
        q, s_excl, s_tris, s_tiles, s_blocks, s_count, dead = shadow
        n_tris = r.tris_packed.shape[0]
        log(f" rt={r.rt}: primary items {int(count)}, shadow items "
            f"{int(s_count)}")
        for tb in (r.tb, r.tb // 2):
            p_list = (tile_ids, block_ids, count)
            s_list = (s_tiles, s_blocks, s_count)
            if tb != r.tb:
                p_list, s_list = split_blocks(*p_list), split_blocks(*s_list)
            for shared in (True, False):
                kw = dict(rt=r.rt, tb=tb, shared_origin=shared)
                tag = f"rt={r.rt} tb={tb} {'shared' if shared else 'per-ray'}"
                if shared:
                    init, gid_base = (None, None), None
                    p_args = (rays, no_excl, tris_cam) + p_list
                    s_args = (q, s_excl, s_tris) + s_list
                else:
                    # Per-ray origins (the reversed shadow rays start at
                    # their light) with a carried init and a gid offset.
                    init_t = np.where(rng.random(n_ray) < 0.3, 2.5, np.inf)
                    init = (jnp.asarray(init_t, jnp.float32),
                            jnp.asarray(rng.integers(0, n_tris, n_ray),
                                        jnp.int32))
                    gid_base = jnp.int32(12345)
                    p_args = (rays, no_excl, r.tris_packed) + p_list
                    s_blocks_loc = s_list[1] % (n_tris // tb)
                    s_args = (q, jnp.where(s_excl >= 0, s_excl % n_tris, -1),
                              r.tris_packed, s_list[0], s_blocks_loc,
                              s_list[2])
                fp, extra = compare_nearest(f"nearest {tag}", p_args, kw,
                                            init, gid_base)
                s_init = (dead if shared else
                          jnp.asarray(rng.random(q.shape[1]) < 0.2,
                                      jnp.int32))
                compare_any(f"any {tag}", s_args, kw, s_init, gid_base)
                if not printed:
                    log("  memory_analysis (nearest kernel, config-5 list):",
                        fp.lower(*p_args, *extra).compile().memory_analysis())
                    printed = True


# ---------------------------------------------------------------------------
# Phases 2-4: frames
# ---------------------------------------------------------------------------

def phase_config5(r5, scene5, card, frames: int = 24):
    import jax

    from distributed_raytracer.runtime import animation

    cam0 = scene5.camera.to_arrays()
    sync = np.asarray(r5.render(cam0, block=True))
    fast = np.asarray(r5.render_fast(cam0, verify=True))
    err = float(np.abs(fast - sync).max())
    log(f"  render_fast vs sync render: max abs {err:.2e}")
    check(err <= 1e-5, "config 5: render_fast == sync render (<= 1e-5)")
    check(float(sync.sum()) > 0, "config 5: frame is not black")
    poses = [p.to_arrays() for p in animation.orbit_camera_path(
        scene5.camera, frames, radius=3.0, revolutions=0.05)]
    jax.block_until_ready(r5.render_fast(poses[0]))
    times = []
    for cam in poses:
        t0 = time.perf_counter()
        jax.block_until_ready(r5.render_fast(cam))
        times.append(time.perf_counter() - t0)
    r5.render_fast(poses[-1], verify=True)
    ms = np.asarray(times) * 1e3
    log(f"  config 5 (5.24M tris, 640x480, 3 lights), {frames} render_fast "
        f"frames: median {np.median(ms):.2f} ms, p90 "
        f"{np.percentile(ms, 90):.2f} ms [{card}]")
    return ms


def phase_correctness(w5=640, h5=480, w3=160, h3=120):
    import jax

    from distributed_raytracer.ops.render import render_frame
    from distributed_raytracer.ops.render_bvh import CulledRenderer
    from distributed_raytracer.utils import oracle, scenes

    s5 = scenes.icosphere_scene(5)
    r = CulledRenderer(s5, w5, h5, block_size="auto")
    cam = s5.camera.to_arrays()
    got = np.asarray(r.render(cam, block=True))
    dense = np.asarray(render_frame(jax.device_put(r.arrays_host), cam, w5,
                                    h5))
    err = float(np.abs(got - dense).max())
    log(f"  icosphere(5) {w5}x{h5} culled vs dense: max abs {err:.2e}")
    check(err <= 1e-3, "culled == dense render (max abs <= 1e-3)")

    s3 = scenes.icosphere_scene(3)
    r3 = CulledRenderer(s3, w3, h3, block_size="auto")
    got3 = np.asarray(r3.render(s3.camera, block=True))
    want3 = oracle.render_oracle(s3, w3, h3)
    err3 = float(np.abs(got3 - want3).mean())
    log(f"  icosphere(3) {w3}x{h3} culled vs float64 oracle: mean abs "
        f"{err3:.2e}")
    check(err3 <= 1e-4, "culled == float64 oracle (mean abs <= 1e-4)")


def phase_bounces(w=1920, h=1080, depth=2):
    import jax

    from distributed_raytracer.ops.render import render_frame_bounced
    from distributed_raytracer.ops.render_bvh import CulledRenderer
    from distributed_raytracer.utils import scenes

    s3 = scenes.icosphere_scene(3)
    r = CulledRenderer(s3, w, h, block_size="auto")
    render = r.freeze_bounced(s3.camera, depth=depth)
    cam = s3.camera.to_arrays()
    got = np.asarray(render(cam, verify=True))
    want = np.asarray(render_frame_bounced(jax.device_put(r.arrays_host),
                                           cam, w, h, depth))
    err = float(np.abs(got - want).max())
    log(f"  bounced depth {depth} {w}x{h} vs dense bounced: max abs "
        f"{err:.2e}")
    check(err <= 1e-3, "bounced culled == dense bounced (max abs <= 1e-3)")


# ---------------------------------------------------------------------------
# Phase 5: the CLI on a procedural OBJ+JSON scene
# ---------------------------------------------------------------------------

def write_grid_scene(out_dir: str, subdivisions: int, n: int,
                     spacing: float = 3.0) -> str:
    """An n x n grid of one icosphere OBJ (smooth normals), 3 lights, a
    camera that frames the grid; returns the scene JSON path."""
    from distributed_raytracer.utils import scenes

    os.makedirs(out_dir, exist_ok=True)
    mesh = scenes.icosphere_mesh(subdivisions)
    obj = os.path.join(out_dir, f"ico{subdivisions}.obj")
    f1 = mesh.faces_v + 1
    with open(obj, "w") as f:
        np.savetxt(f, mesh.vertices, fmt="v %.9f %.9f %.9f")
        np.savetxt(f, mesh.normals, fmt="vn %.9f %.9f %.9f")
        np.savetxt(f, np.repeat(f1, 2, axis=1),
                   fmt="f %d//%d %d//%d %d//%d")
    half = (n - 1) / 2.0
    objs = [{"model": os.path.basename(obj),
             "pos": {"x": (i - half) * spacing, "y": (j - half) * spacing,
                     "z": 0.0}}
            for j in range(n) for i in range(n)]
    dist = spacing * n * 1.2 + 2.0
    doc = {
        "objs": objs,
        "lights": [
            {"pos": {"x": 5.0, "y": 5.0, "z": 8.0},
             "col": {"r": 255, "g": 255, "b": 255}},
            {"pos": {"x": -6.0, "y": 4.0, "z": 6.0},
             "col": {"r": 255, "g": 80, "b": 80}},
            {"pos": {"x": 0.0, "y": -6.0, "z": 7.0},
             "col": {"r": 80, "g": 80, "b": 255}}],
        "cam": {"pos": {"x": 0.0, "y": 0.0, "z": dist},
                "dir": {"x": 0.0, "y": 0.0, "z": -1.0}, "fov": 1.04719755},
    }
    path = os.path.join(out_dir, f"grid{n}_ico{subdivisions}.json")
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def phase_cli(subdivisions=6, n=4, w=640, h=480, frames=30):
    from distributed_raytracer import run
    from distributed_raytracer.models.scene import load_scene

    path = write_grid_scene(SMOKE_DIR, subdivisions, n)
    n_tris = load_scene(path).num_tris
    dist = 3.0 * n * 1.2 + 2.0
    log(f"  scene {path}: {n}x{n} icosphere({subdivisions}), "
        f"{n_tris} triangles")
    base = [path, str(w), str(h), "--frames", str(frames), "--fps-target",
            "0", "--radius", str(dist)]
    for extra in ([], ["--bounces", "1"]):
        argv = base + ["--mode", "culled"] + extra
        log(f"  run.main({' '.join(argv[1:])})")
        rc = run.main(argv)
        check(rc == 0, f"CLI {' '.join(extra) or 'culled'} exits 0")


# ---------------------------------------------------------------------------
# Four cards
# ---------------------------------------------------------------------------

def phase_four_cards(card, n_dev=4, band_size=(3840, 2160), band_sub=6,
                     band_grid=2, geo_size=(640, 480), geo_sub=9, reps=5):
    import jax

    from distributed_raytracer.models.scene import load_scene
    from distributed_raytracer.ops.render_bvh import CulledRenderer
    from distributed_raytracer.parallel import (halo_bvh, render_sharded_bvh,
                                                ring_bvh)
    from distributed_raytracer.utils import scenes

    devices = jax.devices()[:n_dev]
    check(len(devices) == n_dev, f"{n_dev} devices present")

    def single_image(scene, w, h):
        r = CulledRenderer(scene, w, h)
        return np.asarray(r.render(scene.camera, block=True))

    def compare(label, got, want, fn):
        err = float(np.abs(got - want).max())
        ms = timed(fn, reps) * 1e3
        log(f"  {label}: max abs vs single card {err:.2e}, frame median "
            f"{np.median(ms):.2f} ms [{card}]")
        check(err <= 2e-5, f"{label} == single-card image (<= 2e-5)")

    w, h = band_size
    grid = load_scene(write_grid_scene(SMOKE_DIR, band_sub, band_grid))
    log(f"  bands scene: {band_grid}x{band_grid} icosphere({band_sub}), "
        f"{grid.num_tris} triangles, {w}x{h}")
    want = single_image(grid, w, h)
    mesh = jax.make_mesh((n_dev,), (render_sharded_bvh.AXIS,),
                         devices=devices)
    cam = grid.camera.to_arrays()
    for balance in (False, True):
        r = render_sharded_bvh.make_sharded_culled_renderer(
            grid, w, h, mesh=mesh, balance=balance)
        got = r(grid.camera, verify=True)
        compare(f"sharded-bvh {'balanced' if balance else 'equal'} bands",
                got, want, lambda: r.device_fn(cam))

    w, h = geo_size
    scene = scenes.icosphere_scene(geo_sub)
    log(f"  geometry-sharded scene: icosphere({geo_sub}), "
        f"{scene.num_tris} triangles, {w}x{h}")
    want = single_image(scene, w, h)
    cam = scene.camera.to_arrays()
    for name, mod, cls in (("halo", halo_bvh, halo_bvh.HaloCulledRenderer),
                           ("ring", ring_bvh, ring_bvh.RingCulledRenderer)):
        mesh = jax.make_mesh((n_dev,), (mod.AXIS,), devices=devices)
        r = cls(scene, w, h, mesh=mesh)
        got = r.render(scene.camera, verify=True)
        compare(name, got, want, lambda: r.device_fn(cam))


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the four-card schedules")
    args = p.parse_args(argv)

    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: JAX backend is {jax.default_backend()!r}, not a "
              "GPU; nothing was run", file=sys.stderr)
        return 2

    from distributed_raytracer.ops.pallas.bsr_trace import traversal_route
    from distributed_raytracer.utils.jaxtools import enable_compilation_cache

    cache = enable_compilation_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    card = smi.splitlines()[0]
    log(smi)
    devs = jax.devices()
    log(f"jax {jax.__version__}, backend {jax.default_backend()}, "
        f"{devs[0].device_kind} x{len(devs)}, cache {cache}, traversal "
        f"route {traversal_route()}")
    t_start = time.perf_counter()

    def phase(name, fn, *a):
        log(f"== {name}")
        t0 = time.perf_counter()
        out = fn(*a)
        log(f"   ({time.perf_counter() - t0:.1f} s)")
        return out

    if args.four_cards:
        phase("four cards: bands, halo, ring vs one card", phase_four_cards,
              card)
        count = 4
    else:
        from distributed_raytracer.ops.render_bvh import CulledRenderer
        from distributed_raytracer.utils import scenes

        def build5():
            scene5 = scenes.icosphere_scene(9)
            r5 = CulledRenderer(scene5, 640, 480, ray_tile=256, tile_w=16,
                                block_size="auto")
            r5.freeze(scene5.camera)
            others = [CulledRenderer(None, 640, 480,
                                     prebaked=(r5.arrays_host, r5.tree),
                                     ray_tile=rt, tile_w=32)
                      for rt in (512, 1024)]
            for r in others:
                r.freeze(scene5.camera)
            log(f"  icosphere(9): {scene5.num_tris} triangles, leaf "
                f"{r5.tb}")
            return scene5, r5, others

        scene5, r5, others = phase("config-5 scene, bake and sizing", build5)
        phase("1. traversal kernels vs XLA traversal", phase_kernels,
              [r5] + others, scene5.camera.to_arrays())
        del others
        phase("2. config-5 frames", phase_config5, r5, scene5, card)
        del r5
        phase("3. correctness vs dense and oracle", phase_correctness)
        phase("4. bounces vs dense", phase_bounces)
        phase("5. CLI end to end", phase_cli)
        count = len(devs)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
