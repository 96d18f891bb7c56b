"""Möller–Trumbore boundary semantics vs closed-form cases (triangle.go:37-77)."""

import numpy as np
import jax.numpy as jnp

from distributed_raytracer.models.camera import Camera
from distributed_raytracer.models.objparse import Material, MeshData
from distributed_raytracer.models.scene import Scene, SceneObject
from distributed_raytracer.ops import intersect


def scene_from_tris(tris, lights_pos=None, lights_col=None):
    """Build a Scene holding a raw triangle list [(p0,p1,p2), ...]."""
    tris = np.asarray(tris, dtype=np.float64)
    nf = tris.shape[0]
    mesh = MeshData(
        vertices=tris.reshape(-1, 3),
        normals=np.zeros((0, 3)),
        faces_v=np.arange(nf * 3, dtype=np.int32).reshape(nf, 3),
        faces_n=np.full((nf, 3), -1, dtype=np.int32),
        face_mat=np.zeros(nf, dtype=np.int32),
        materials=[Material()],
    )
    cam = Camera.create([0, 0, 5], [0, 0, -1], 1.0)
    lp = np.zeros((0, 3)) if lights_pos is None else np.asarray(lights_pos, float)
    lc = np.zeros((0, 3)) if lights_col is None else np.asarray(lights_col, float)
    return Scene(meshes={"m": mesh}, objects=[SceneObject(1, "m", np.zeros(3))],
                 light_pos=lp.reshape(-1, 3), light_col=lc.reshape(-1, 3), camera=cam)


UNIT_TRI = [[(0, 0, 0), (1, 0, 0), (0, 1, 0)]]  # in z=0 plane


def hit_one(tri_scene, origin, direction):
    arrs = tri_scene.bake()
    o = jnp.asarray(origin, jnp.float32)
    d = jnp.asarray(direction, jnp.float32)
    d = d / jnp.linalg.norm(d)
    return intersect.nearest_hit(arrs, o[None, :], d[None, :])


def test_center_hit():
    s = scene_from_tris(UNIT_TRI)
    h = hit_one(s, [0.25, 0.25, 1.0], [0, 0, -1])
    assert bool(h.valid[0])
    assert np.allclose(h.t[0], 1.0, atol=1e-6)


def test_miss_outside():
    s = scene_from_tris(UNIT_TRI)
    h = hit_one(s, [0.75, 0.75, 1.0], [0, 0, -1])  # beyond the hypotenuse
    assert not bool(h.valid[0])


def test_edge_and_vertex_inclusive():
    """Boundary barycentrics are inclusive (triangle.go:52-66 uses <=/>=)."""
    s = scene_from_tris(UNIT_TRI)
    assert bool(hit_one(s, [0.0, 0.0, 1.0], [0, 0, -1]).valid[0])   # vertex P1
    assert bool(hit_one(s, [0.5, 0.0, 1.0], [0, 0, -1]).valid[0])   # edge P1P2
    assert bool(hit_one(s, [0.5, 0.5, 1.0], [0, 0, -1]).valid[0])   # hypotenuse


def test_behind_origin_rejected():
    s = scene_from_tris(UNIT_TRI)
    h = hit_one(s, [0.25, 0.25, -1.0], [0, 0, -1])  # triangle is behind
    assert not bool(h.valid[0])


def test_backface_hit_allowed():
    """No backface culling: only dirScale >= 0 is required (triangle.go:68-71)."""
    s = scene_from_tris(UNIT_TRI)
    h = hit_one(s, [0.25, 0.25, -1.0], [0, 0, 1])  # from behind, toward +z
    assert bool(h.valid[0])
    assert np.allclose(h.t[0], 1.0, atol=1e-6)


def test_parallel_ray_rejected():
    s = scene_from_tris(UNIT_TRI)
    h = hit_one(s, [0.25, 0.25, 1.0], [1, 0, 0])  # parallel to plane
    assert not bool(h.valid[0])


def test_nearest_of_two():
    s = scene_from_tris([
        [(0, 0, 0), (1, 0, 0), (0, 1, 0)],
        [(0, 0, 2), (1, 0, 2), (0, 1, 2)],
    ])
    h = hit_one(s, [0.25, 0.25, 5.0], [0, 0, -1])
    assert bool(h.valid[0])
    assert np.allclose(h.t[0], 3.0, atol=1e-5)  # z=2 plane wins
    assert int(h.tri[0]) == 1


def test_any_hit_t_max():
    s = scene_from_tris(UNIT_TRI)
    arrs = s.bake()
    o = jnp.asarray([[0.25, 0.25, 1.0]], jnp.float32)
    d = jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32)
    assert bool(intersect.any_hit(arrs, o, d, jnp.asarray([1.5], jnp.float32))[0])
    assert not bool(intersect.any_hit(arrs, o, d, jnp.asarray([0.5], jnp.float32))[0])


def test_barycentrics_match():
    s = scene_from_tris(UNIT_TRI)
    arrs = s.bake()
    o = jnp.asarray([0.25, 0.5, 1.0], jnp.float32)
    d = jnp.asarray([[0.0, 0.0, -1.0]], jnp.float32)
    h = intersect.nearest_hit(arrs, o, d)
    u, v, x = intersect.barycentrics_at(arrs, o, d, h.t, h.tri)
    # Point (0.25, 0.5): u = weight of P2 = x-coord, v = weight of P3 = y-coord.
    assert np.allclose(u[0], 0.25, atol=1e-5)
    assert np.allclose(v[0], 0.5, atol=1e-5)
    assert np.allclose(x[0], [0.25, 0.5, 0.0], atol=1e-5)


def test_translation_offset():
    """Object placement offsets geometry (object.go:72-76's ray offset)."""
    s = scene_from_tris(UNIT_TRI)
    s.set_object_pos(1, [0, 0, -3])
    h = hit_one(s, [0.25, 0.25, 1.0], [0, 0, -1])
    assert bool(h.valid[0])
    assert np.allclose(h.t[0], 4.0, atol=1e-5)


def test_padding_tris_never_hit():
    s = scene_from_tris(UNIT_TRI)
    arrs = s.bake()
    assert arrs.num_tris % 128 == 0
    # Fire a grid of rays; any hit index must be a real triangle (idx 0).
    o = jnp.asarray([0.25, 0.25, 1.0], jnp.float32)
    dirs = np.random.default_rng(0).normal(size=(64, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    h = intersect.nearest_hit(arrs, o, jnp.asarray(dirs))
    assert np.all(np.asarray(h.tri)[np.asarray(h.valid)] == 0)
