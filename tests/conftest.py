"""Test harness configuration.

Tests run on the CPU backend with 8 virtual devices so multi-device sharding
logic is exercised without accelerator hardware — the JAX analog of the
reference's "test multi-node with GCE VMs" strategy (final_report.pdf §3.1,
SURVEY.md §4).
Must run before jax initializes, hence module scope in conftest.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
# Force CPU: tests must not depend on (or hold) an accelerator. jax.config
# wins over the env var. The traversal takes its XLA route here; kernel tests
# run the Pallas kernels in interpret mode.
os.environ["JAX_PLATFORMS"] = "cpu"

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest

from distributed_raytracer.models import scene as scene_mod

REFERENCE_EXAMPLE = "/root/reference/example/scene.json"


def make_tetra_obj(path, with_normals=True, with_mtl=True):
    """Write a small procedural tetrahedron OBJ (+MTL) asset for tests."""
    mtl_path = os.path.splitext(path)[0] + ".mtl"
    lines = []
    if with_mtl:
        lines.append(f"mtllib {os.path.basename(mtl_path)}")
    verts = [(0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1)]
    faces = [(1, 3, 2), (1, 2, 4), (1, 4, 3), (2, 3, 4)]
    for v in verts:
        lines.append(f"v {v[0]} {v[1]} {v[2]}")
    if with_normals:
        norms = []
        va = np.array(verts, dtype=float)
        for f in faces:
            a, b, c = va[f[0] - 1], va[f[1] - 1], va[f[2] - 1]
            n = np.cross(b - a, c - a)
            n = n / np.linalg.norm(n)
            norms.append(n)
        for n in norms:
            lines.append(f"vn {n[0]:.9f} {n[1]:.9f} {n[2]:.9f}")
        if with_mtl:
            lines.append("usemtl red")
        for k, f in enumerate(faces):
            lines.append(f"f {f[0]}//{k+1} {f[1]}//{k+1} {f[2]}//{k+1}")
    else:
        if with_mtl:
            lines.append("usemtl red")
        for f in faces:
            lines.append(f"f {f[0]} {f[1]} {f[2]}")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    if with_mtl:
        with open(mtl_path, "w") as fh:
            fh.write("newmtl red\nNs 8\nKa 0.05 0.05 0.05\nKd 0.9 0.2 0.1\nKs 0.4 0.4 0.4\n")
    return path


@pytest.fixture(scope="session")
def tetra_scene(tmp_path_factory):
    """A tetrahedron + two lights scene, fully procedural (no external assets)."""
    d = tmp_path_factory.mktemp("tetra")
    make_tetra_obj(str(d / "tetra.obj"))
    scene_json = d / "scene.json"
    scene_json.write_text(
        """
        {"objs": [{"model": "tetra.obj", "pos": {"x": 0.0, "y": 0.0, "z": 0.0}}],
         "lights": [
           {"pos": {"x": 3.0, "y": 4.0, "z": 5.0}, "col": {"r": 255, "g": 255, "b": 255}},
           {"pos": {"x": -4.0, "y": 2.0, "z": 3.0}, "col": {"r": 64, "g": 128, "b": 255}}
         ],
         "cam": {"pos": {"x": 1.5, "y": 1.2, "z": 3.0},
                 "dir": {"x": -0.35, "y": -0.3, "z": -1.0},
                 "fov": 1.04719755}}
        """
    )
    return scene_mod.load_scene(str(scene_json))


@pytest.fixture(scope="session")
def suzanne_scene():
    """The reference example scene (968-tri Suzanne), if mounted."""
    if not os.path.exists(REFERENCE_EXAMPLE):
        pytest.skip("reference example scene not available")
    return scene_mod.load_scene(REFERENCE_EXAMPLE)


@pytest.fixture(scope="session")
def two_tetra_scene(tmp_path_factory):
    """Two tetra instances + two lights — the minimal scene for per-frame
    SceneDiff tests (object AND light motion)."""
    d = tmp_path_factory.mktemp("two_tetra")
    make_tetra_obj(str(d / "tetra.obj"))
    p = d / "scene.json"
    p.write_text(
        '{"objs": ['
        '{"model": "tetra.obj", "pos": {"x": 0, "y": 0, "z": 0}},'
        '{"model": "tetra.obj", "pos": {"x": -1.6, "y": 0.4, "z": -0.8}}],'
        '"lights": ['
        '{"pos": {"x": 3, "y": 4, "z": 5}, "col": {"r": 255, "g": 255, "b": 255}},'
        '{"pos": {"x": -4, "y": 2, "z": 3}, "col": {"r": 64, "g": 128, "b": 255}}],'
        '"cam": {"pos": {"x": 0.4, "y": 1.0, "z": 4.2},'
        '"dir": {"x": -0.1, "y": -0.25, "z": -1.0}, "fov": 1.0472}}')
    return scene_mod.load_scene(str(p))
