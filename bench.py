"""Benchmark harness: renders the BASELINE.json configs and reports Mrays/s.

    python bench.py [--config 1,loop,2,3,4,5]

Runs every selected config in THIS process (one process per card: a second
JAX process could not reserve the card's memory) and prints exactly ONE
JSON line to stdout:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
   "device": {"platform", "kind", "count"}, ...per-config extras}

Headline metric: primary Mrays/s per device on config 1 (the example scene,
640x480, primary + shadow rays), the faster of the dense and block-sparse
paths. Baseline: the reference's best published throughput — 25.16 FPS at
320x240 (final_report.pdf §3.2) = 1.93 M primary rays/s aggregate over 96
vCPUs (BASELINE.md "Derived").

Every config prints its scene and triangle count on stderr before it runs:
without the reference asset, configs 1-4 render a procedural icosahedron
stand-in for the example scene, and their triangle counts say so. A config
that fails records `configN_error` and the others still run. The camera
orbits between frames (the reference's measurement motion), so per-frame
state updates are exercised without recompilation.

Work accounting: each block-sparse config also reports scheduled
(ray, triangle) pair throughput and its share of the device's f32 peak
(utils/profiling.py); a device without a peak on record gets none.
"""

import argparse
import json
import sys
import time

BASELINE_MRAYS = 1.93  # reference aggregate primary rays/s (96 vCPUs)


def _say(config: str, scene_name: str, scene) -> None:
    print(f"config {config}: {scene_name}, {scene.num_tris} triangles",
          file=sys.stderr, flush=True)


def _bench_frames(render, cams, n_frames):
    """Mean seconds per frame over n_frames dispatches (one final block)."""
    import jax

    cams = [jax.device_put(c) for c in cams]
    jax.block_until_ready(render(cams[0]))
    t0 = time.perf_counter()
    for k in range(n_frames):
        out = render(cams[k % len(cams)])
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n_frames


def _culled_extras(extras, key, renderer, seconds, w, h):
    """Per-config work accounting: scheduled pairs and peak share."""
    import jax

    from distributed_raytracer.utils import profiling

    lc = renderer._last_counts   # per-level, hit tiles, per-level
    work = profiling.FrameWork(
        primary_cells=int(lc[renderer.n_levels - 1]),
        shadow_cells=int(lc[-1]), rays=w * h, ray_tile=renderer.rt,
        tri_block=renderer.tb, seconds=seconds,
        device_kind=jax.devices()[0].device_kind)
    extras[f"{key}_gpairs_per_s"] = round(work.gpairs_per_sec, 2)
    extras[f"{key}_pairs_scheduled"] = int(work.pairs)
    frac = work.peak_fraction
    if frac is not None:
        extras[f"{key}_f32_peak_fraction"] = round(frac, 4)


def _culled(extras, key, scene, w, h, poses, n_frames, **kw):
    from distributed_raytracer.ops.render_bvh import CulledRenderer

    r = CulledRenderer(scene, w, h, **kw)
    r.render(scene.camera, block=True)
    r.freeze(scene.camera)
    s = _bench_frames(lambda c: r.render_fast(c),
                      [p.to_arrays() for p in poses], n_frames)
    extras[f"{key}_frame_ms"] = round(s * 1e3, 3)
    extras[f"{key}_mrays"] = round(w * h / s / 1e6, 3)
    extras[f"{key}_n_tris"] = int(scene.num_tris)
    _culled_extras(extras, key, r, s, w, h)
    return s


def config1(extras):
    """Example scene at 640x480: culled (adopted leaf policy) and dense."""
    import jax

    from distributed_raytracer.ops.render import render_frame
    from distributed_raytracer.runtime import animation
    from __graft_entry__ import _example_scene

    w, h = 640, 480
    scene = _example_scene()
    _say("1", "example scene or its procedural stand-in", scene)
    poses = animation.orbit_camera_path(scene.camera, 8, radius=6.0,
                                        revolutions=0.05)
    culled_s = _culled(extras, "config1", scene, w, h, poses, 20,
                       block_size="auto")
    arrays = jax.device_put(scene.bake())
    dense_s = _bench_frames(lambda c: render_frame(arrays, c, w, h),
                            [p.to_arrays() for p in poses], 20)
    extras["config1_dense_frame_ms"] = round(dense_s * 1e3, 3)
    return min(culled_s, dense_s), scene


def config2(extras):
    """Example scene at 1920x1080 with specular reflections (depth 2)."""
    from distributed_raytracer.ops.render_bvh import CulledRenderer
    from distributed_raytracer.runtime import animation
    from __graft_entry__ import _example_scene

    w, h = 1920, 1080
    scene = _example_scene()
    _say("2", "example scene or its procedural stand-in", scene)
    r = CulledRenderer(scene, w, h)
    render = r.freeze_bounced(scene.camera, depth=2)
    poses = animation.orbit_camera_path(scene.camera, 4, radius=6.0,
                                        revolutions=0.02)
    s = _bench_frames(render, [p.to_arrays() for p in poses], 8)
    extras["config2_1080p_bounce2_frame_ms"] = round(s * 1e3, 3)
    extras["config2_1080p_bounce2_mrays"] = round(w * h / s / 1e6, 3)


def config3(extras):
    """8x8 instanced example mesh (~62K tris with the reference asset)."""
    from distributed_raytracer.runtime import animation
    from distributed_raytracer.utils import scenes as S
    from __graft_entry__ import _example_scene

    big = S.instanced_grid(_example_scene(), 8)
    _say("3", "8x8 instanced example mesh", big)
    poses = animation.orbit_camera_path(big.camera, 4, radius=20.0,
                                        revolutions=0.02)
    _culled(extras, "config3", big, 640, 480, poses, 8, block_size="auto")


def config4(extras):
    """12x12 instanced example mesh (~139K tris) at 3840x2160."""
    from distributed_raytracer.runtime import animation
    from distributed_raytracer.utils import scenes as S
    from __graft_entry__ import _example_scene

    c4 = S.instanced_grid(_example_scene(), 12)
    _say("4", "12x12 instanced example mesh", c4)
    poses = animation.orbit_camera_path(c4.camera, 3, radius=30.0,
                                        revolutions=0.015)
    _culled(extras, "config4", c4, 3840, 2160, poses, 4, ray_tile=1024,
            block_size=64)


def config5(extras):
    """icosphere_scene(9): 5.24M triangles, 3 lights, 640x480, 16x16 ray
    tiles, through the block-sparse path."""
    from distributed_raytracer.runtime import animation
    from distributed_raytracer.utils import scenes as S

    scene = S.icosphere_scene(9)
    _say("5", "icosphere(9)", scene)
    poses = animation.orbit_camera_path(scene.camera, 3, radius=3.0,
                                        revolutions=0.01)
    _culled(extras, "config5", scene, 640, 480, poses, 4, ray_tile=256,
            tile_w=16, block_size="auto")


def config_loop(extras):
    """The interactive frame loop end to end: scripted orbit input ->
    camera controller -> pipelined culled dispatch -> in-order display,
    with the reference-exact FPS statistics and drop rate
    (master/main.go:240-325's 30 Hz loop and exit report)."""
    from distributed_raytracer.ops.render_bvh import CulledRenderer
    from distributed_raytracer.runtime import animation, framebuffer
    from distributed_raytracer.runtime.loop import run_loop
    from __graft_entry__ import _example_scene

    w, h, n_frames = 640, 480, 300
    scene = _example_scene()
    _say("loop", "example scene or its procedural stand-in", scene)
    r = CulledRenderer(scene, w, h, block_size="auto")
    r.render(scene.camera, block=True)
    r.freeze(scene.camera)
    events = list(animation.orbit_events(w, n_frames, fov=scene.camera.fov))
    _, stats, dropped = run_loop(
        None, scene.camera,
        lambda s, c: framebuffer.to_u8_device(r.render_fast(c)), w, h,
        events=events, display=lambda idx, img: None)
    extras["loop_frames"] = int(stats.frames_total)
    extras["loop_mean_fps"] = round(stats.mean_fps, 2)
    extras["loop_median_fps"] = round(stats.median_fps, 2)
    extras["loop_drop_pct"] = round(
        100.0 * dropped / max(stats.frames_total, 1), 2)


CONFIGS = {"loop": config_loop, "2": config2, "3": config3, "4": config4,
           "5": config5}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="render benchmark")
    p.add_argument("--config", default="1,loop,2,3,4,5",
                   help="comma-separated configs to run (1 always runs)")
    args = p.parse_args(argv)

    import jax

    from distributed_raytracer.utils.jaxtools import enable_compilation_cache

    enable_compilation_cache()
    t0 = time.monotonic()
    extras = {}
    best_s, scene = config1(extras)
    for name in args.config.split(","):
        if name == "1":
            continue
        t = time.monotonic()
        try:
            CONFIGS[name](extras)
        except Exception as e:  # one failed config must not hide the rest
            extras[f"config{name}_error"] = repr(e)[:300]
        extras[f"config{name}_wall_s"] = round(time.monotonic() - t, 1)
    extras["bench_wall_s"] = round(time.monotonic() - t0, 1)

    dev = jax.devices()[0]
    n_lights = int(scene.light_pos.shape[0])
    mrays = 640 * 480 / best_s / 1e6
    print(json.dumps({
        "metric": "primary_mrays_per_sec_per_device",
        "value": round(mrays, 3),
        "unit": "Mrays/s",
        "vs_baseline": round(mrays / BASELINE_MRAYS, 2),
        "fps": round(1.0 / best_s, 2),
        "resolution": "640x480",
        "n_tris": int(scene.num_tris),
        "n_lights": n_lights,
        "total_rays_per_frame_incl_shadow": 640 * 480 * (1 + n_lights),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        **extras,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
