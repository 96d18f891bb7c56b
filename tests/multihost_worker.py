"""Worker process for the multi-host tests (tests/test_multihost.py).

One OS process per "host", each with 2 virtual CPU devices — the JAX analog
of the reference's GCE-VM workers (final_report.pdf §3.1). Process 0 plays
the master (worker registration -> jax.distributed.initialize barrier;
frame assembly -> multihost.gather_frame).

Modes (argv[6], default "dense") cover every schedule family that must
survive a REAL process boundary — the registrar/worker topology
(master/registrar.go:25-67) is only proven when the production paths
(Pallas work lists under shard_map, cross-process collectives, host-0
assembly) run across one:
  dense                row-sharded dense sweep (the original proof)
  sharded-bvh          per-band cull + BSR work lists, geometry replicated
  sharded-bvh-balanced cost-balanced band heights
  sharded-bvh-bounced  the band pipeline with depth-1 reflection bounces
  halo                 geometry block-partitioned, rays exchanged
                       (all_to_all/all_gather across the process boundary)
  ring                 geometry rotated across the process boundary
                       (ppermute inside lax.scan over DCN)
"""

import os
import sys


def main() -> int:
    pid, nproc, port, scene_path, out_path = sys.argv[1:6]
    mode = sys.argv[6] if len(sys.argv) > 6 else "dense"
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax

    jax.config.update("jax_platforms", "cpu")

    # jax.distributed.initialize must run before anything touches the XLA
    # backend — including the package import (module-level jnp constants in
    # ops/). multihost.initialize documents the same constraint.
    jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                               num_processes=int(nproc), process_id=int(pid))

    import numpy as np

    from distributed_raytracer.parallel import multihost
    assert jax.process_count() == int(nproc), jax.process_count()
    assert len(jax.devices()) == 2 * int(nproc), len(jax.devices())

    from distributed_raytracer.models.scene import load_scene

    scene = load_scene(scene_path)
    w, h = 48, 36

    if mode == "dense":
        from distributed_raytracer.parallel import render_sharded

        arrays = scene.bake()
        mesh = multihost.global_mesh("tiles")
        render = render_sharded.make_sharded_renderer(w, h, mesh=mesh)
        out = render.device_fn(arrays, scene.camera.to_arrays())
        frame = multihost.gather_frame(out)
        frame = (frame[:w * h].reshape(h, w, 3)
                 if frame is not None else None)
    elif mode in ("sharded-bvh", "sharded-bvh-balanced"):
        from distributed_raytracer.parallel import render_sharded_bvh

        mesh = multihost.global_mesh(render_sharded_bvh.AXIS)
        # The band renderer's inputs are uncommitted local arrays; the
        # global-mesh jit replicates them to every process's devices — the
        # analog of the registrar shipping the full scene to every worker
        # (registrar.go:41-47). This is exactly run.py's --multihost path.
        r = render_sharded_bvh.make_sharded_culled_renderer(
            scene, w, h, mesh=mesh,
            balance=mode.endswith("balanced"))
        band = r.band
        out, _ = r.device_fn(scene.camera.to_arrays())
        full = multihost.gather_frame(out)
        if full is None:
            frame = None
        elif mode.endswith("balanced"):
            n = int(mesh.devices.size)
            band_h = full.shape[0] // n
            _, rows = r.layout()
            img = full.reshape(n, band_h, w, 3)
            parts = [img[b, :int(rows[b]) * band.tile_h] for b in range(n)]
            frame = np.concatenate(parts, axis=0)[:h]
        else:
            frame = full[:h]
    elif mode == "sharded-bvh-bounced":
        from distributed_raytracer.parallel import render_sharded_bvh

        mesh = multihost.global_mesh(render_sharded_bvh.AXIS)
        r = render_sharded_bvh.make_sharded_bounced_renderer(
            scene, w, h, 1, mesh=mesh)
        out, _ = r.device_fn(scene.camera.to_arrays())
        full = multihost.gather_frame(out)
        frame = full[:h] if full is not None else None
    elif mode == "halo":
        from distributed_raytracer.parallel import halo_bvh

        mesh = multihost.global_mesh(halo_bvh.AXIS)
        r = halo_bvh.HaloCulledRenderer(scene, w, h, mesh=mesh)
        rows, _ = r.device_fn(scene.camera.to_arrays())
        full = multihost.gather_frame(rows)
        frame = r._assemble(full) if full is not None else None
    elif mode == "ring":
        from distributed_raytracer.parallel import ring_bvh

        mesh = multihost.global_mesh(ring_bvh.AXIS)
        r = ring_bvh.RingCulledRenderer(scene, w, h, mesh=mesh)
        rows, _ = r.device_fn(scene.camera.to_arrays())
        full = multihost.gather_frame(rows)
        frame = r._assemble(full) if full is not None else None
    else:
        raise SystemExit(f"unknown mode {mode}")

    if multihost.is_master():
        assert frame is not None
        np.save(out_path, frame)
    else:
        assert frame is None
    jax.distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
