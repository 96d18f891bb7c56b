"""BVH-culled ring (geometry-rotation) renderer vs replicated paths.

The culled ring (parallel/ring_bvh.py) must match the dense renderer
image-exactly: the per-step cull is conservative and the carried
(t, then global-id) fold is rotation-order-independent, so shard count and
rotation order cannot change a pixel. It must also agree with the culled
halo renderer — two transports, one image."""

import jax
import numpy as np
import pytest

from distributed_raytracer.ops.render import render_frame
from distributed_raytracer.parallel import halo_bvh, ring_bvh
from distributed_raytracer.utils import scenes as S


@pytest.fixture(scope="module")
def mesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jax.make_mesh((8,), (ring_bvh.AXIS,))


def test_ring_bvh_matches_dense_tetra(tetra_scene, mesh8):
    w, h = 64, 48
    dense = np.asarray(render_frame(
        jax.device_put(tetra_scene.bake()), tetra_scene.camera.to_arrays(),
        w, h))
    r = ring_bvh.RingCulledRenderer(tetra_scene, w, h, mesh=mesh8)
    out = r.render(tetra_scene.camera)
    np.testing.assert_allclose(out, dense, atol=2e-5)


def test_ring_bvh_matches_dense_suzanne(suzanne_scene, mesh8):
    w, h = 64, 48
    dense = np.asarray(render_frame(
        jax.device_put(suzanne_scene.bake()),
        suzanne_scene.camera.to_arrays(), w, h))
    r = ring_bvh.RingCulledRenderer(suzanne_scene, w, h, mesh=mesh8)
    out = r.render(suzanne_scene.camera)
    diff = np.abs(out - dense).max(-1)
    assert (diff > 2 / 255).mean() < 0.005
    assert np.abs(out - dense).mean() < 1e-3


def test_ring_bvh_equals_halo_bvh(suzanne_scene, mesh8):
    """Two geometry-sharded transports (rotation vs exchange), one image."""
    big = S.instanced_grid(suzanne_scene, 3)
    w, h = 96, 64
    mesh_h = jax.make_mesh((8,), (halo_bvh.AXIS,))
    hr = halo_bvh.HaloCulledRenderer(big, w, h, mesh=mesh_h)
    rr = ring_bvh.RingCulledRenderer(big, w, h, mesh=mesh8)
    a = hr.render(big.camera, verify=True)
    b = rr.render(big.camera, verify=True)
    np.testing.assert_array_equal(a, b)


def test_ring_bvh_dynamic_diff(two_tetra_scene, mesh8):
    """Per-frame SceneDiff on the ring schedule: the diff folds into each
    shard BEFORE rotation, so every step streams updated geometry."""
    import copy

    from distributed_raytracer.models.scene import SceneDiff
    from distributed_raytracer.ops.render import render_frame

    scene = two_tetra_scene
    w, h = 96, 64
    r = ring_bvh.RingCulledRenderer(scene, w, h, mesh=mesh8, dynamic=True,
                                    margin=4.0)
    moved = copy.deepcopy(scene)
    moved.set_object_pos(2, [-0.9, 0.4, -1.2])
    moved.light_pos = moved.light_pos.copy()
    moved.light_pos[0] = [1.5, 4.5, 5.5]
    want = np.asarray(render_frame(
        jax.device_put(moved.bake()), scene.camera.to_arrays(), w, h))
    got = np.asarray(r.render_dynamic(scene.camera, moved.make_diff(),
                                      verify=True))
    bad = (np.abs(got - want).max(-1) > 2 / 255).mean()
    assert bad < 0.005, f"{bad:.4f} mismatched"


def test_ring_bvh_bounces_equal_halo_and_dense(suzanne_scene, mesh8):
    """Reflection bounces on the ring schedule: reflection rays stay
    RESIDENT (the ring never moves rays), so a bounce is one more
    geometry rotation with per-ray origins. Must be bit-equal to the halo
    schedule's bounce (two transports, one image) and match the replicated
    dense multi-bounce path."""
    from distributed_raytracer.ops.render import render_frame_bounced

    w, h = 64, 48
    mesh_h = jax.make_mesh((8,), (halo_bvh.AXIS,))
    rb = ring_bvh.RingCulledRenderer(suzanne_scene, w, h, mesh=mesh8, bounces=1)
    img_r = rb.render(suzanne_scene.camera, verify=True)
    hb = halo_bvh.HaloCulledRenderer(suzanne_scene, w, h, mesh=mesh_h, bounces=1)
    img_h = hb.render(suzanne_scene.camera, verify=True)
    np.testing.assert_array_equal(img_r, img_h)
    dense = np.asarray(render_frame_bounced(
        jax.device_put(suzanne_scene.bake()),
        suzanne_scene.camera.to_arrays(), w, h, 1))
    diff = np.abs(img_r - dense).max(-1)
    assert (diff > 2 / 255).mean() < 0.005
    assert np.abs(img_r - dense).mean() < 1e-3


def test_ring_bvh_dynamic_bounced(two_tetra_scene, mesh8):
    """SceneDiff + bounces compose on the ring: the diff folds into each
    shard before the first rotation, so every bounce's rotation streams
    updated geometry (one tracer core serves every topology and every
    frame's EnvMutables — tracer.go:81, master/main.go:260-266)."""
    import copy

    from distributed_raytracer.ops.render import render_frame_bounced

    scene = two_tetra_scene
    w, h = 96, 64
    r = ring_bvh.RingCulledRenderer(scene, w, h, mesh=mesh8, dynamic=True,
                                    bounces=1, margin=4.0)
    moved = copy.deepcopy(scene)
    moved.set_object_pos(2, [-0.9, 0.4, -1.2])
    moved.light_pos = moved.light_pos.copy()
    moved.light_pos[0] = [1.5, 4.5, 5.5]
    want = np.asarray(render_frame_bounced(
        jax.device_put(moved.bake()), scene.camera.to_arrays(), w, h, 1))
    got = np.asarray(r.render_dynamic(scene.camera, moved.make_diff(),
                                      verify=True))
    bad = (np.abs(got - want).max(-1) > 2 / 255).mean()
    assert bad < 0.005, f"{bad:.4f} mismatched"


def test_ring_bvh_square_tiles_halve_pairs(suzanne_scene, mesh8):
    """Squarer ray tiles (16x16 at ray_tile=256) have tighter interval
    hulls than the default 32x16 strip, so the per-step cull schedules
    >=2x fewer (ray, triangle) pairs on an instanced mesh grid — at an
    identical image (the cull is conservative either way). The per-step
    hierarchy + tile shape mirror the reference pruning every query
    through its R-trees (mesh.go:139)."""
    big = S.instanced_grid(suzanne_scene, 4)
    w, h = 160, 120
    r_def = ring_bvh.RingCulledRenderer(big, w, h, mesh=mesh8)
    a = r_def.render(big.camera, verify=True)
    p_def = r_def.scheduled_pairs()
    r_sq = ring_bvh.RingCulledRenderer(big, w, h, mesh=mesh8, ray_tile=256,
                                       tile_w=16)
    b = r_sq.render(big.camera, verify=True)
    p_sq = r_sq.scheduled_pairs()
    assert p_def >= 2.0 * p_sq, (p_def, p_sq)
    np.testing.assert_allclose(a, b, atol=2e-5)


def test_ring_bvh_multilevel_local_cull(suzanne_scene, mesh8):
    """Force the 2-level local hierarchy on a small scene (local_levels=2):
    the per-step multilevel walk must reproduce the flat walk's image
    bit-exactly (the descent only skips provably-empty member groups)."""
    w, h = 64, 48
    flat = ring_bvh.RingCulledRenderer(suzanne_scene, w, h, mesh=mesh8, local_levels=1)
    hier = ring_bvh.RingCulledRenderer(suzanne_scene, w, h, mesh=mesh8, local_levels=2,
                                       local_group=4)
    a = flat.render(suzanne_scene.camera, verify=True)
    b = hier.render(suzanne_scene.camera, verify=True)
    np.testing.assert_array_equal(a, b)
    assert len(hier.loc_groups) == 1 and len(flat.loc_groups) == 0
