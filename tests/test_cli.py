"""CLI entry point (the reference-binaries analog) driven end-to-end."""

import os
import subprocess
import sys

import numpy as np
import pytest

from distributed_raytracer.runtime import framebuffer


@pytest.fixture(scope="module")
def scene_path(tmp_path_factory):
    from tests.conftest import make_tetra_obj
    d = tmp_path_factory.mktemp("cli")
    make_tetra_obj(str(d / "tetra.obj"))
    p = d / "scene.json"
    p.write_text(
        '{"objs": [{"model": "tetra.obj", "pos": {"x": 0, "y": 0, "z": 0}}],'
        '"lights": [{"pos": {"x": 3, "y": 4, "z": 5},'
        '"col": {"r": 255, "g": 255, "b": 255}}],'
        '"cam": {"pos": {"x": 1.5, "y": 1.2, "z": 3.0},'
        '"dir": {"x": -0.35, "y": -0.3, "z": -1.0}, "fov": 1.0472}}')
    return str(p)


def run_cli(args):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    # Pin the child to the CPU through jax.config as well as the env var.
    code = (
        "import jax; jax.config.update('jax_platforms','cpu');"
        "from distributed_raytracer.run import main;"
        f"import sys; sys.exit(main({args!r}))"
    )
    return subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_cli_sequential(scene_path, tmp_path):
    out = str(tmp_path / "frames")
    res = run_cli([scene_path, "48", "36", "--mode", "sequential",
                   "--frames", "4", "--fps-target", "0", "--out", out,
                   "--animation", "strafe"])
    assert res.returncode == 0, res.stderr[-2000:]
    assert "Mean FPS" in res.stdout and "Throughput" in res.stdout
    files = sorted(os.listdir(out))
    assert files == [f"frame_{k:05d}.png" for k in range(4)]


def test_cli_culled(scene_path, tmp_path):
    res = run_cli([scene_path, "48", "36", "--mode", "culled",
                   "--frames", "3", "--fps-target", "0",
                   "--animation", "orbit", "--radius", "3"])
    assert res.returncode == 0, res.stderr[-2000:]
    assert "Median FPS" in res.stdout


def test_cli_sharded(scene_path):
    res = run_cli([scene_path, "40", "30", "--mode", "sharded",
                   "--frames", "2", "--fps-target", "0",
                   "--animation", "none"])
    assert res.returncode == 0, res.stderr[-2000:]
    assert "Mean FPS" in res.stdout


def test_cli_sharded_bvh(scene_path):
    res = run_cli([scene_path, "48", "36", "--mode", "sharded-bvh",
                   "--frames", "2", "--fps-target", "0",
                   "--animation", "none", "--devices", "4"])
    assert res.returncode == 0, res.stderr[-2000:]
    assert "Mean FPS" in res.stdout


def test_cli_bounces(scene_path):
    res = run_cli([scene_path, "48", "36", "--mode", "culled",
                   "--bounces", "1", "--frames", "2", "--fps-target", "0",
                   "--animation", "none"])
    assert res.returncode == 0, res.stderr[-2000:]
    assert "Mean FPS" in res.stdout


def test_cli_halo(scene_path):
    res = run_cli([scene_path, "48", "36", "--mode", "halo",
                   "--frames", "2", "--fps-target", "0",
                   "--animation", "none", "--devices", "4"])
    assert res.returncode == 0, res.stderr[-2000:]
    assert "Mean FPS" in res.stdout


def test_cli_ring(scene_path):
    res = run_cli([scene_path, "48", "36", "--mode", "ring",
                   "--frames", "2", "--fps-target", "0",
                   "--animation", "none", "--devices", "4"])
    assert res.returncode == 0, res.stderr[-2000:]
    assert "Mean FPS" in res.stdout


def test_cli_bad_args(scene_path):
    res = run_cli(["nonexistent.json", "48", "36"])
    assert res.returncode != 0


def test_cli_animate_objects(scene_path, tmp_path):
    """--animate-objects end to end: every written CLI frame must match a
    dense render of the scene RE-BAKED at that frame's object position —
    the per-WorkOrder EnvMutables semantics (master/main.go:260-266)."""
    out = str(tmp_path / "anim")
    res = run_cli([scene_path, "48", "36", "--mode", "culled",
                   "--animate-objects", "--object-radius", "0.6",
                   "--frames", "3", "--fps-target", "0",
                   "--animation", "none", "--out", out])
    assert res.returncode == 0, res.stderr[-2000:]
    assert "Mean FPS" in res.stdout

    import jax

    from distributed_raytracer.models.scene import load_scene
    from distributed_raytracer.ops.render import render_frame
    from distributed_raytracer.runtime import animation

    scene = load_scene(scene_path)
    diffs = animation.orbit_object_diffs(scene, 3, radius=0.6,
                                         revolutions=1.0)
    assert not np.allclose(diffs[1].obj_pos, diffs[0].obj_pos)
    for k in range(3):
        got = framebuffer.read_png(os.path.join(out, f"frame_{k:05d}.png"))
        scene.objects[0].pos = np.asarray(diffs[k].obj_pos[0], np.float64)
        dense = render_frame(jax.device_put(scene.bake()),
                             scene.camera.to_arrays(), 48, 36)
        want = framebuffer.to_u8(np.asarray(dense))
        err = np.abs(got.astype(int) - want.astype(int)).max(-1)
        assert (err > 2).mean() < 0.005, k     # discontinuity pixels only
        assert err.mean() < 0.5, k


def test_cli_animate_objects_halo(scene_path):
    """Object diffs on SHARDED geometry from the CLI (halo dynamic mode)."""
    res = run_cli([scene_path, "48", "36", "--mode", "halo",
                   "--animate-objects", "--frames", "2", "--fps-target", "0",
                   "--animation", "none", "--devices", "4"])
    assert res.returncode == 0, res.stderr[-2000:]
    assert "Mean FPS" in res.stdout


def test_cli_sharded_bvh_balanced(scene_path):
    res = run_cli([scene_path, "48", "64", "--mode", "sharded-bvh",
                   "--balance", "--frames", "2", "--fps-target", "0",
                   "--animation", "none", "--devices", "4"])
    assert res.returncode == 0, res.stderr[-2000:]
    assert "Mean FPS" in res.stdout


def test_cli_ring_bounces_and_animate(scene_path):
    """The round-5 ring capabilities from the CLI: comm-free reflection
    bounces, and per-frame object diffs composed with them."""
    res = run_cli([scene_path, "48", "36", "--mode", "ring",
                   "--bounces", "1", "--frames", "2", "--fps-target", "0",
                   "--animation", "none"])
    assert res.returncode == 0, res.stderr[-2000:]
    assert "Mean FPS" in res.stdout
    res = run_cli([scene_path, "48", "36", "--mode", "ring",
                   "--animate-objects", "--bounces", "1", "--frames", "2",
                   "--fps-target", "0", "--animation", "none"])
    assert res.returncode == 0, res.stderr[-2000:]
    assert "Mean FPS" in res.stdout
