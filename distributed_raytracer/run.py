"""Command-line renderer: the analog of the reference's binaries.

The reference ships three binaries driven by positional argv
(master/main.go:189-215, worker/sequential/main.go:34-41,
worker/distributed/main.go:131-137). Here one CLI covers them:

  python -m distributed_raytracer SCENE.json WIDTH HEIGHT [options]

With no display available, the interactive SDL loop becomes a scripted
camera animation (default: orbit, the reference's benchmark motion); frames
can be written as PNGs, and the exit report reproduces the master's FPS
statistics (master/main.go:285-325) plus Mrays/s.

Modes map to the reference topology:
  sequential  - single-chip dense sweep (worker/sequential analog)
  culled      - single-chip block-BVH path (the production path)
  sharded     - SPMD dense over all local devices (master + workers analog)
  sharded-bvh - SPMD block-BVH bands, geometry replicated (the multi-chip
                production path; supports --bounces)
  halo        - geometry block-partitioned across devices, rays exchanged,
                per-shard BVH culling (the config-5 scale path)
  ring        - geometry rotated past resident rays (ring-attention
                schedule), per-step hierarchical BVH culling

--bounces N adds Whitted specular reflection bounces (every mode except
sequential/sharded: on halo each bounce is a secondary-ray halo exchange;
on ring reflection rays stay resident and bounces are comm-free).
--animate-objects composes with --bounces on halo/ring (per-frame
SceneDiffs fold into every shard before tracing).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="distributed_raytracer",
        description="JAX-native distributed raytracer",
    )
    p.add_argument("scene", help="JSON scene file (reference schema)")
    p.add_argument("width", type=int)
    p.add_argument("height", type=int)
    p.add_argument("--mode", choices=["sequential", "culled", "sharded",
                                      "sharded-bvh", "halo", "ring"],
                   default="culled")
    p.add_argument("--bounces", type=int, default=0,
                   help="Whitted reflection bounces "
                        "(culled / sharded-bvh / halo / ring)")
    p.add_argument("--animate-objects", action="store_true",
                   help="orbit object 0 via per-frame SceneDiffs (the "
                        "reference's per-WorkOrder EnvMutables, "
                        "master/main.go:260-266; culled / halo modes)")
    p.add_argument("--object-radius", type=float, default=1.0,
                   help="orbit radius for --animate-objects")
    p.add_argument("--frames", type=int, default=60,
                   help="animation frames to render")
    p.add_argument("--animation", choices=["orbit", "strafe", "none"],
                   default="orbit")
    p.add_argument("--radius", type=float, default=6.0,
                   help="orbit radius (distance to look-at point)")
    p.add_argument("--revolutions", type=float, default=1.0)
    p.add_argument("--out", default=None,
                   help="directory to write frame PNGs (omit to skip IO)")
    p.add_argument("--fps-target", type=int, default=30,
                   help="pace frames like the reference's 30 Hz loop; 0 = flat out")
    p.add_argument("--devices", type=int, default=None,
                   help="device count for --mode sharded")
    p.add_argument("--balance", action="store_true",
                   help="cost-balanced band heights for --mode sharded-bvh "
                        "(the least-loaded-scheduler analog)")
    p.add_argument("--serve", metavar="HOST:PORT", default=None,
                   help="serve an interactive browser viewer instead of the "
                        "scripted animation (the SDL window analog)")
    p.add_argument("--multihost", action="store_true",
                   help="join a jax.distributed gang (the master/worker "
                        "topology analog); process 0 assembles + reports")
    p.add_argument("--coordinator", metavar="HOST:PORT", default=None,
                   help="coordinator address for --multihost (process 0 "
                        "binds it, the registrar analog)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    return p


def _periodic_verify(render_v, period: int = 8):
    """Run bucket-overflow verification every `period` frames only.

    verify=True blocks on the frame's true work counts (host syncs that
    would stall an interactive loop if done per frame). Checking every 8th
    frame bounds a silent overflow to 7 frames while keeping the loop
    async, the same containment granularity as the reference's 2 s trace
    timeout vs 33 ms frames."""
    k = [0]

    def render(cam):
        v = (k[0] % period) == 0
        k[0] += 1
        return render_v(cam, v)

    return render


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)

    import jax

    if args.multihost or args.coordinator:
        # Must precede anything that touches the XLA backend (the package
        # import itself is backend-free by design).
        jax.distributed.initialize(coordinator_address=args.coordinator,
                                   num_processes=args.num_processes,
                                   process_id=args.process_id)

    from distributed_raytracer.ops.pallas.bsr_trace import traversal_route
    from distributed_raytracer.parallel import multihost
    from distributed_raytracer.utils.jaxtools import enable_compilation_cache
    enable_compilation_cache()
    print(f"backend {jax.default_backend()}, "
          f"{jax.devices()[0].device_kind} x{len(jax.devices())}, "
          f"traversal {traversal_route()}", flush=True)

    from distributed_raytracer.models.scene import load_scene
    from distributed_raytracer.ops.render import render_frame
    from distributed_raytracer.ops.render_bvh import CulledRenderer
    from distributed_raytracer.parallel import render_sharded
    from distributed_raytracer.runtime import animation, framebuffer
    from distributed_raytracer.runtime.stats import FrameTimer

    scene = load_scene(args.scene)
    w, h = args.width, args.height

    to_image = None   # multihost halo/ring: assemble gathered rows on host 0
    render_k = None   # set when frames depend on the index (object diffs)
    diffs = None
    if args.animate_objects:
        if args.mode not in ("culled", "halo", "ring") or (
                args.bounces and args.mode == "culled"):
            raise SystemExit("--animate-objects supports --mode "
                             "culled/halo/ring (--bounces on halo/ring)")
        if args.multihost or (args.serve and args.mode != "culled"):
            raise SystemExit("--animate-objects + --serve needs --mode "
                             "culled; --multihost is unsupported")
        diffs = animation.orbit_object_diffs(
            scene, args.frames, radius=args.object_radius,
            revolutions=args.revolutions)
    if args.mode == "sequential":
        arrays = jax.device_put(scene.bake())
        render = lambda cam: render_frame(arrays, cam.to_arrays(), w, h)
        render_arrays = lambda c: render_frame(arrays, c, w, h)
    elif args.mode == "culled" and args.animate_objects:
        # Per-frame object/light diffs through the fused dynamic pipeline
        # (ops/render_dynamic.py) — the EnvMutables-in-every-WorkOrder
        # analog, end to end from the CLI.
        from distributed_raytracer.ops.render_dynamic import (
            DynamicCulledRenderer)

        dyn = DynamicCulledRenderer(scene, w, h)
        dyn.render(scene.camera, block=True)
        dyn.freeze(scene.camera)
        render_k = lambda k, cam: dyn.render_dynamic(
            cam.to_arrays(), diffs[k], verify=(k % 8 == 0))

        # For --serve: advance the object orbit one diff per rendered
        # frame (frames are produced on input change, the reference's
        # main.go:246 rule, so the object moves as the viewer interacts).
        _dk = [0]

        def render_arrays(c):
            d = diffs[_dk[0] % len(diffs)]
            _dk[0] += 1
            return dyn.render_dynamic(c, d, verify=(_dk[0] % 8 == 1))
    elif args.mode == "culled":
        # block_size="auto": the measured per-scene leaf policy
        # (utils/config.default_block_size).
        culled = CulledRenderer(scene, w, h, block_size="auto")
        if args.bounces:
            bounced = culled.freeze_bounced(scene.camera, args.bounces)
            render = _periodic_verify(
                lambda cam, v: bounced(cam.to_arrays(), verify=v))
            render_arrays = bounced
        else:
            culled.render(scene.camera, block=True)
            culled.freeze(scene.camera)
            render = _periodic_verify(
                lambda cam, v: culled.render_fast(cam, verify=v))
            render_arrays = lambda c: culled.render_fast(c)
    elif args.mode == "sharded-bvh":
        from distributed_raytracer.parallel import render_sharded_bvh
        ndev = args.devices or len(jax.devices())
        mesh = jax.make_mesh((ndev,), (render_sharded_bvh.AXIS,))
        if args.bounces:
            r = render_sharded_bvh.make_sharded_bounced_renderer(
                scene, w, h, args.bounces, mesh=mesh)
        else:
            r = render_sharded_bvh.make_sharded_culled_renderer(
                scene, w, h, mesh=mesh, balance=args.balance)
        if args.multihost:
            render = lambda cam: r.device_fn(cam.to_arrays())[0]
            to_image = lambda a: np.asarray(a)[:h]
        else:
            render = _periodic_verify(lambda cam, v: r(cam, verify=v))
        render_arrays = lambda c: r.device_fn(c)[0]
    elif args.mode in ("halo", "ring"):
        if args.mode == "halo":
            from distributed_raytracer.parallel import halo_bvh as gmod
            cls = gmod.HaloCulledRenderer
            extra = {"bounces": args.bounces}   # secondary-ray halo rounds
        else:
            from distributed_raytracer.parallel import ring_bvh as gmod
            cls = gmod.RingCulledRenderer
            # Ring bounces are comm-free: reflection rays stay resident
            # and the next rotation streams geometry past them.
            extra = {"bounces": args.bounces}
        ndev = args.devices or len(jax.devices())
        mesh = jax.make_mesh((ndev,), (gmod.AXIS,))
        if args.animate_objects:     # halo only (guarded above)
            extra["dynamic"] = True
        r = cls(scene, w, h, mesh=mesh, **extra)
        if args.animate_objects:
            render_k = lambda k, cam: r.render_dynamic(
                cam.to_arrays(), diffs[k], verify=(k % 8 == 0))
            render_arrays = lambda c: r.render_dynamic(c, diffs[0])
        elif args.multihost:
            # Device rows stay sharded; host 0 assembles after the gather.
            render = lambda cam: r.device_fn(cam.to_arrays())[0]
            to_image = r._assemble
            render_arrays = lambda c: r.device_fn(c)[0]
        else:
            render = _periodic_verify(lambda cam, v: r.render(cam, verify=v))
            render_arrays = lambda c: r.device_fn(c)[0]
    else:
        arrays = jax.device_put(scene.bake())
        mesh = (multihost.global_mesh("tiles") if args.multihost
                else render_sharded.default_mesh(args.devices))
        sharded = render_sharded.make_sharded_renderer(w, h, mesh=mesh)
        render = lambda cam: sharded.device_fn(arrays, cam.to_arrays())
        render_arrays = lambda c: sharded.device_fn(arrays, c)
        to_image = lambda flat: np.asarray(flat)[:w * h].reshape(h, w, 3)

    if args.serve:
        from distributed_raytracer.runtime import viewer as viewer_mod

        host, _, port = args.serve.rpartition(":")
        cam, stats, dropped = viewer_mod.serve(
            None, scene.camera,
            lambda s, c: render_arrays(c), w, h,
            host=host or "127.0.0.1", port=int(port),
            on_ready=lambda v: print(f"viewer at {v.url}", flush=True))
        if stats is not None:
            print(stats.report())
        return 0

    if args.animation == "none":
        poses = [scene.camera] * args.frames
    elif args.animation == "strafe":
        poses = []
        cam = scene.camera
        for _ in range(args.frames):
            cam = cam.move(0.1, leftward=True)
            poses.append(cam)
    else:
        poses = animation.orbit_camera_path(scene.camera, args.frames,
                                            radius=args.radius,
                                            revolutions=args.revolutions)

    # Warm up compile outside the timed loop (the reference never counts
    # startup either — its first frame just runs slow).
    warm = render_k(0, poses[0]) if render_k is not None else render(poses[0])
    jax.block_until_ready(jax.tree.leaves(warm)[0])

    if args.out:
        os.makedirs(args.out, exist_ok=True)

    timer = FrameTimer()
    ms_per_frame = 1000.0 / args.fps_target if args.fps_target else 0.0
    for k, cam in enumerate(poses):
        tick = time.monotonic()
        timer.frame_issued()
        img = render_k(k, cam) if render_k is not None else render(cam)
        if args.out and not args.multihost and isinstance(img, jax.Array):
            # u8 conversion ON DEVICE before the host pull: the PNG export
            # needs u8 anyway (colour.go:59-61's truncation) and the
            # transfer then carries 1 byte/channel instead of a float32.
            img = framebuffer.to_u8_device(img)
        # Frame assembly: host 0 gathers in multihost mode (the coordinator
        # painting worker tiles, master/main.go:163-177); None elsewhere.
        img_np = (multihost.gather_frame(img) if args.multihost
                  else np.asarray(img))
        timer.frame_drawn()
        if img_np is not None and to_image is not None:
            img_np = to_image(img_np)
        if args.out and img_np is not None:
            framebuffer.write_png(os.path.join(args.out, f"frame_{k:05d}.png"),
                                  img_np[:h])
        if ms_per_frame:
            elapsed = (time.monotonic() - tick) * 1000.0
            if elapsed < ms_per_frame:
                time.sleep((ms_per_frame - elapsed) / 1000.0)

    stats = timer.stats()
    if stats is not None and (not args.multihost or multihost.is_master()):
        print(stats.report())
        rays = w * h * (1 + scene.light_pos.shape[0])
        print(f"Throughput: {stats.mean_fps * w * h / 1e6:.2f} M primary rays/s "
              f"({stats.mean_fps * rays / 1e6:.2f} M total rays/s incl. shadows).")
    return 0


if __name__ == "__main__":
    sys.exit(main())
