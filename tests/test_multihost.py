"""Multi-host execution proven with 2 real jax.distributed processes.

The reference's identity is a master + N networked workers
(master/registrar.go:25-67, worker/distributed/main.go:146-185). The JAX
equivalent is the multi-controller runtime: N OS processes join a gang via
a coordinator port, shard one program over the union of their devices, and
host 0 assembles the frame. This test launches two CPU processes (2 virtual
devices each -> a 4-device global mesh spanning process boundaries), renders
row-sharded across both, and asserts host-0's gathered frame equals the
single-process render — the "test multi-node without a cluster" strategy of
SURVEY.md §4 taken to real process boundaries."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def scene_path(tmp_path_factory):
    from tests.conftest import make_tetra_obj
    d = tmp_path_factory.mktemp("mh")
    make_tetra_obj(str(d / "tetra.obj"))
    p = d / "scene.json"
    p.write_text(
        '{"objs": [{"model": "tetra.obj", "pos": {"x": 0, "y": 0, "z": 0}}],'
        '"lights": [{"pos": {"x": 3, "y": 4, "z": 5},'
        '"col": {"r": 255, "g": 255, "b": 255}}],'
        '"cam": {"pos": {"x": 1.5, "y": 1.2, "z": 3.0},'
        '"dir": {"x": -0.35, "y": -0.3, "z": -1.0}, "fov": 1.0472}}')
    return str(p)


def test_two_process_render_matches_single(scene_path, tmp_path):
    port = _free_port()
    out = str(tmp_path / "frame.npy")
    worker = os.path.join(os.path.dirname(__file__), "multihost_worker.py")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env["JAX_PLATFORMS"] = "cpu"
    procs = [subprocess.Popen(
        [sys.executable, worker, str(i), "2", str(port), scene_path, out],
        env=env, cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for i in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se[-3000:]

    got = np.load(out)

    # Single-process reference with the same tetra scene.
    import jax
    from distributed_raytracer.models.scene import load_scene
    from distributed_raytracer.ops.render import render_frame

    scene = load_scene(scene_path)
    want = np.asarray(render_frame(jax.device_put(scene.bake()),
                                   scene.camera.to_arrays(), 48, 36))
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_cli_multihost(scene_path, tmp_path):
    """run.py --multihost over 2 processes: master writes frames + stats."""
    port = _free_port()
    out = str(tmp_path / "frames")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env["JAX_PLATFORMS"] = "cpu"

    def code(pid):
        return (
            "import jax; jax.config.update('jax_platforms','cpu');"
            "from distributed_raytracer.run import main; import sys;"
            f"sys.exit(main([{scene_path!r}, '40', '30', '--mode', 'sharded',"
            f" '--frames', '2', '--fps-target', '0', '--animation', 'none',"
            f" '--out', {out!r}, '--multihost',"
            f" '--coordinator', '127.0.0.1:{port}',"
            f" '--num-processes', '2', '--process-id', '{pid}']))"
        )

    procs = [subprocess.Popen([sys.executable, "-c", code(i)], env=env,
                              cwd=repo, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for i in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se[-3000:]
    # Master (process 0) printed the FPS report and wrote both frames.
    assert "Mean FPS" in outs[0][0]
    assert "Mean FPS" not in outs[1][0]
    assert sorted(os.listdir(out)) == ["frame_00000.png", "frame_00001.png"]


def _run_workers(scene_path, tmp_path, mode: str, nproc: int) -> np.ndarray:
    """Launch nproc real jax.distributed processes running `mode`; return
    host-0's assembled frame."""
    port = _free_port()
    out = str(tmp_path / f"frame_{mode}_{nproc}.npy")
    worker = os.path.join(os.path.dirname(__file__), "multihost_worker.py")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env["JAX_PLATFORMS"] = "cpu"
    procs = [subprocess.Popen(
        [sys.executable, worker, str(i), str(nproc), str(port), scene_path,
         out, mode],
        env=env, cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for i in range(nproc)]
    outs = [p.communicate(timeout=420) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se[-3000:]
    return np.load(out)


def _single_process_reference(scene_path):
    import jax
    from distributed_raytracer.models.scene import load_scene
    from distributed_raytracer.ops.render import render_frame

    scene = load_scene(scene_path)
    return np.asarray(render_frame(jax.device_put(scene.bake()),
                                   scene.camera.to_arrays(), 48, 36))


@pytest.mark.parametrize("mode,nproc", [
    ("sharded-bvh", 2),
    pytest.param("sharded-bvh", 4, marks=pytest.mark.slow),
    ("sharded-bvh-balanced", 2),
    ("halo", 2),
    pytest.param("halo", 4, marks=pytest.mark.slow),
    pytest.param("ring", 2, marks=pytest.mark.slow),
])
def test_production_paths_cross_process(scene_path, tmp_path, mode, nproc):
    """The PRODUCTION schedules across REAL process boundaries: Pallas
    work lists under shard_map, cross-process collectives (halo:
    all_to_all + all_gather over the boundary), and host-0 assembly must
    reproduce the single-process frame — the registrar/worker topology
    (master/registrar.go:25-67, worker/distributed/main.go:146-185) proven
    on the paths that would actually run on a pod slice, not just the
    dense row shard."""
    got = _run_workers(scene_path, tmp_path, mode, nproc)
    want = _single_process_reference(scene_path)
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.slow
def test_bounced_bands_cross_process(scene_path, tmp_path):
    """Reflection bounces on the band pipeline across a real process
    boundary: host-0's frame equals the single-process replicated bounced
    render (the per-bounce Pallas work lists and the framebuffer gather
    both cross the boundary)."""
    import jax

    from distributed_raytracer.models.scene import load_scene
    from distributed_raytracer.ops.render import render_frame_bounced

    got = _run_workers(scene_path, tmp_path, "sharded-bvh-bounced", 2)
    scene = load_scene(scene_path)
    want = np.asarray(render_frame_bounced(
        jax.device_put(scene.bake()), scene.camera.to_arrays(), 48, 36, 1))
    np.testing.assert_allclose(got, want, atol=2e-5)
