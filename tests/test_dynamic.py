"""Per-frame object/light diffs (the EnvMutables analog) vs full re-bakes.

The reference ships object positions + lights in every frame's diff
(shared/state/environment.go:65-69); the dynamic renderer folds the same
diff into the packed device arrays under jit (ops/render_dynamic.py). Every
frame here moves BOTH an object and a light, and the diffed image must
match a from-scratch re-bake rendered densely."""

import copy

import jax
import numpy as np
import pytest

from distributed_raytracer.models import scene as scene_mod
from distributed_raytracer.ops.render import render_frame
from distributed_raytracer.ops.render_dynamic import DynamicCulledRenderer


@pytest.fixture(scope="module")
def two_tetra(tmp_path_factory):
    from tests.conftest import make_tetra_obj
    d = tmp_path_factory.mktemp("dyn")
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


def test_diff_moves_objects_and_lights(two_tetra):
    w, h = 96, 64
    r = DynamicCulledRenderer(two_tetra, w, h)
    r.freeze(two_tetra.camera, margin=3.0)

    for k in range(3):
        # Mutate: slide object 2 and orbit light 1 each frame.
        moved = copy.deepcopy(two_tetra)
        moved.set_object_pos(2, [-1.6 + 0.5 * (k + 1), 0.4, -0.8 - 0.3 * k])
        moved.light_pos = moved.light_pos.copy()
        moved.light_pos[0] = [3 - 1.2 * k, 4, 5 + 0.8 * k]

        got = np.asarray(r.render_dynamic(two_tetra.camera,
                                          moved.make_diff(), verify=True))
        want = np.asarray(render_frame(jax.device_put(moved.bake()),
                                       moved.camera.to_arrays(), w, h))
        diff = np.abs(got - want).max(-1)
        # The diff path recomputes plane_d/c_u/c_v in f32 from the baked
        # values; a fresh bake derives them in f64 — boundary pixels may
        # flip, nothing else.
        assert (diff > 2 / 255).mean() < 0.005, k
        assert np.abs(got - want).mean() < 1e-3, k


def test_zero_diff_matches_static(two_tetra):
    """An identity diff must reproduce the static fused render exactly."""
    w, h = 64, 48
    r = DynamicCulledRenderer(two_tetra, w, h)
    r.freeze(two_tetra.camera)
    static = np.asarray(r.render_fast(two_tetra.camera))
    dyn = np.asarray(r.render_dynamic(two_tetra.camera,
                                      two_tetra.make_diff()))
    np.testing.assert_array_equal(static, dyn)


def test_grouped_bake_matches_plain(two_tetra):
    """The per-object-grouped bake renders identically to the global bake
    (same triangles, different block layout — images must agree)."""
    from distributed_raytracer.ops.render_bvh import CulledRenderer

    w, h = 64, 48
    a = CulledRenderer(two_tetra, w, h)
    b = DynamicCulledRenderer(two_tetra, w, h)
    ia = np.asarray(a.render(two_tetra.camera, block=True))
    ib = np.asarray(b.render(two_tetra.camera, block=True))
    diff = np.abs(ia - ib).max(-1)
    assert (diff > 2 / 255).mean() < 0.002
