"""OBJ/MTL parser tests, incl. hand-counted Suzanne stats (SURVEY.md §7.1)."""

import os

import numpy as np
import pytest

from distributed_raytracer.models.objparse import Material, parse_mtl, parse_obj

SUZANNE = "/root/reference/example/suzanne.obj"


def test_tetra_parse(tmp_path):
    from tests.conftest import make_tetra_obj
    path = make_tetra_obj(str(tmp_path / "t.obj"))
    mesh = parse_obj(path)
    assert mesh.vertices.shape == (4, 3)
    assert mesh.faces_v.shape == (4, 3)
    assert mesh.has_normals
    assert np.allclose(np.linalg.norm(mesh.normals, axis=1), 1.0)
    assert len(mesh.materials) == 1
    m = mesh.materials[0]
    assert m.kd == (0.9, 0.2, 0.1) and m.ns == 8.0


def test_tetra_no_normals_no_mtl(tmp_path):
    from tests.conftest import make_tetra_obj
    path = make_tetra_obj(str(tmp_path / "t.obj"), with_normals=False, with_mtl=False)
    mesh = parse_obj(path)
    assert not mesh.has_normals
    assert np.all(mesh.faces_n == -1)
    # Default material: Ka=0x10 grey, Kd=white, Ks=black, Ns=0 (mesh.go:151)
    m = mesh.materials[0]
    assert m == Material()
    assert abs(m.ka[0] - 0x10 / 255.0) < 1e-12


def test_quad_triangulation(tmp_path):
    p = tmp_path / "quad.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1 2 3 4\n")
    mesh = parse_obj(str(p))
    assert mesh.faces_v.shape == (2, 3)  # fan: (0,1,2), (0,2,3)
    assert mesh.faces_v.tolist() == [[0, 1, 2], [0, 2, 3]]


def test_negative_indices(tmp_path):
    p = tmp_path / "neg.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf -3 -2 -1\n")
    mesh = parse_obj(str(p))
    assert mesh.faces_v.tolist() == [[0, 1, 2]]


def test_vertex_dedup(tmp_path):
    p = tmp_path / "dup.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nv 0 0 0\nf 1 2 3\nf 4 2 3\n")
    mesh = parse_obj(str(p))
    # Exact-duplicate vertices collapse (mesh.go:146-148's hash-map dedup).
    assert mesh.vertices.shape == (3, 3)
    assert mesh.faces_v.tolist() == [[0, 1, 2], [0, 1, 2]]


def test_mtl_clamping(tmp_path):
    p = tmp_path / "m.mtl"
    p.write_text("newmtl hot\nKa 2.0 -0.5 0.5\nKd 1 1 1\nKs 0 0 0\nNs 10\n")
    lib = parse_mtl(str(p))
    assert lib["hot"].ka == (1.0, 0.0, 0.5)  # NewRGBFromFloats clamps (colour.go:33-35)


@pytest.mark.skipif(not os.path.exists(SUZANNE), reason="reference assets not mounted")
def test_suzanne_stats():
    mesh = parse_obj(SUZANNE)
    # 507 v lines / 507 vn / 500 f (468 quads + 32 tris) -> 968 triangles.
    # Two v lines are exact duplicates (±0.203125, 0.09375, 0.742188), so the
    # reference's value-keyed dedup (mesh.go:146-148) also yields 505.
    assert mesh.vertices.shape == (505, 3)
    assert mesh.faces_v.shape == (968, 3)
    assert mesh.has_normals
    assert mesh.normals.shape[0] <= 507
    assert len(mesh.materials) == 1
    m = mesh.materials[0]
    assert m.ns == 10.0
    assert np.allclose(m.ka, 0.1) and np.allclose(m.kd, 0.8) and np.allclose(m.ks, 0.5)
    assert np.allclose(np.linalg.norm(mesh.normals, axis=1), 1.0)
