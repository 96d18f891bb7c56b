"""C++ native components vs the Python reference implementations."""

import os

import numpy as np
import pytest

from distributed_raytracer.models import bvh, native
from distributed_raytracer.models.objparse import parse_obj

SUZANNE = "/root/reference/example/suzanne.obj"


@pytest.fixture(scope="module", autouse=True)
def require_native():
    if not native.available():
        pytest.skip("native library could not be built")


def assert_mesh_equal(a, b):
    np.testing.assert_array_equal(a.vertices, b.vertices)
    np.testing.assert_array_equal(a.faces_v, b.faces_v)
    np.testing.assert_array_equal(a.face_mat, b.face_mat)
    if a.has_normals or b.has_normals:
        np.testing.assert_allclose(a.normals, b.normals, atol=1e-15)
        np.testing.assert_array_equal(a.faces_n, b.faces_n)
    assert a.materials == b.materials


@pytest.mark.skipif(not os.path.exists(SUZANNE), reason="reference assets not mounted")
def test_native_parser_matches_python_suzanne():
    py = parse_obj(SUZANNE, backend="python")
    nat = parse_obj(SUZANNE, backend="native")
    assert_mesh_equal(nat, py)


def test_native_parser_matches_python_tetra(tmp_path):
    from tests.conftest import make_tetra_obj
    path = make_tetra_obj(str(tmp_path / "t.obj"))
    assert_mesh_equal(parse_obj(path, backend="native"),
                      parse_obj(path, backend="python"))


def test_native_parser_no_normals_no_mtl(tmp_path):
    from tests.conftest import make_tetra_obj
    path = make_tetra_obj(str(tmp_path / "t.obj"), with_normals=False,
                          with_mtl=False)
    assert_mesh_equal(parse_obj(path, backend="native"),
                      parse_obj(path, backend="python"))


def test_native_parser_missing_file():
    with pytest.raises(FileNotFoundError):
        native.parse_obj("/tmp/does-not-exist.obj")


def test_native_morton_matches_python():
    rng = np.random.default_rng(3)
    pts = rng.uniform(-5, 5, size=(4096, 3))
    nat = native.morton_argsort(pts)
    py = np.argsort(bvh.morton_codes(pts), kind="stable")
    np.testing.assert_array_equal(nat, py)


def test_native_bake_matches_numpy(suzanne_scene):
    """The one-pass C++ bake (drt_bake_object + drt_block_bounds) must be
    BIT-IDENTICAL to the NumPy chain (Scene.bake -> bvh.reorder_scene ->
    bvh.build_block_bvh): same f64 math, same f32 casts, same Morton/gap
    layout, same bound-epsilon floor (util.go:7). Covers the plain and the
    per-object-grouped (dynamic) bakes."""
    import numpy as np

    from distributed_raytracer.models import native
    from distributed_raytracer.utils import scenes as S

    if not native.available():
        pytest.skip("native library unavailable")

    def legacy(scene, grouped):
        real = native.load
        native.load = lambda: None
        try:
            return (scene.bake_bvh_grouped() if grouped
                    else scene.bake_bvh())
        finally:
            native.load = real

    for grouped in (False, True):
        scene = S.instanced_grid(suzanne_scene, 2)
        got = (scene.bake_bvh_grouped() if grouped else scene.bake_bvh())
        want = legacy(scene, grouped)
        for f in got[0]._fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(got[0], f)),
                np.asarray(getattr(want[0], f)), err_msg=f)
        np.testing.assert_array_equal(got[1].block_lo, want[1].block_lo)
        np.testing.assert_array_equal(got[1].block_hi, want[1].block_hi)
        assert got[1].block_size == want[1].block_size
        if grouped:
            np.testing.assert_array_equal(got[2], want[2])   # obj_id
            np.testing.assert_array_equal(got[3], want[3])   # block_obj
            np.testing.assert_allclose(got[4], want[4])      # obj_pos0
