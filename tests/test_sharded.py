"""Multi-chip SPMD rendering on the 8-virtual-device CPU mesh.

The JAX analog of the reference's multi-node-on-GCE testing strategy
(SURVEY.md §4c): sharded output must be bit-identical in structure to the
single-chip render, since sharding only re-partitions the ray grid.
"""

import jax
import numpy as np
import pytest

from distributed_raytracer.ops.render import render_frame
from distributed_raytracer.parallel import render_sharded


@pytest.fixture(scope="module")
def mesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return render_sharded.default_mesh(8)


def test_sharded_matches_single_chip(tetra_scene, mesh8):
    arrays = tetra_scene.bake()
    cam = tetra_scene.camera.to_arrays()
    w, h = 64, 48
    single = np.asarray(render_frame(arrays, cam, w, h))
    render = render_sharded.make_sharded_renderer(w, h, mesh=mesh8)
    multi = np.asarray(render(arrays, cam))
    assert multi.shape == (h, w, 3)
    # Same math, same dtype; only the partition differs.
    np.testing.assert_allclose(multi, single, atol=1e-6)


def test_sharded_odd_sizes(tetra_scene, mesh8):
    arrays = tetra_scene.bake()
    cam = tetra_scene.camera.to_arrays()
    w, h = 53, 31  # not divisible by the device count
    single = np.asarray(render_frame(arrays, cam, w, h))
    render = render_sharded.make_sharded_renderer(w, h, mesh=mesh8)
    multi = np.asarray(render(arrays, cam))
    np.testing.assert_allclose(multi, single, atol=1e-6)


def test_sharded_subset_mesh(tetra_scene):
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    arrays = tetra_scene.bake()
    cam = tetra_scene.camera.to_arrays()
    mesh = render_sharded.default_mesh(4)
    render = render_sharded.make_sharded_renderer(40, 30, mesh=mesh)
    img = np.asarray(render(arrays, cam))
    assert img.shape == (30, 40, 3)
    single = np.asarray(render_frame(arrays, cam, 40, 30))
    np.testing.assert_allclose(img, single, atol=1e-6)


@pytest.mark.slow
def test_dryrun_multichip_entrypoint():
    import __graft_entry__
    __graft_entry__.dryrun_multichip(8)


def test_sharded_culled_matches_single(suzanne_scene):
    """Multi-chip block-sparse path == single-chip block-sparse path."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from distributed_raytracer.ops.render_bvh import CulledRenderer
    from distributed_raytracer.parallel import render_sharded_bvh
    w, h = 64, 48
    mesh = jax.make_mesh((8,), (render_sharded_bvh.AXIS,))
    render = render_sharded_bvh.make_sharded_culled_renderer(
        suzanne_scene, w, h, mesh=mesh)
    multi = render(suzanne_scene.camera)
    assert multi.shape == (h, w, 3)

    single = CulledRenderer(suzanne_scene, w, h)
    ref = np.asarray(single.render(suzanne_scene.camera))
    diff = np.abs(multi - ref).max(-1)
    assert (diff > 2 / 255).mean() < 0.005
    assert np.abs(multi - ref).mean() < 1e-3


def test_sharded_culled_odd_height(tetra_scene):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from distributed_raytracer.parallel import render_sharded_bvh
    mesh = jax.make_mesh((8,), (render_sharded_bvh.AXIS,))
    render = render_sharded_bvh.make_sharded_culled_renderer(
        tetra_scene, 40, 30, mesh=mesh)  # 30 % 8 != 0
    out = render(tetra_scene.camera)
    assert out.shape == (30, 40, 3)
    from distributed_raytracer.ops.render import render_frame
    dense = np.asarray(render_frame(render.band.arrays_host,
                                    tetra_scene.camera.to_arrays(), 40, 30))
    np.testing.assert_allclose(out, dense, atol=2e-5)


def test_sharded_culled_overflow_refreeze(tetra_scene):
    """A camera far inside the sizing margin must trigger a bucket re-size
    (not silently wrong pixels) — the multi-chip analog of
    render_fast(verify=True). The reference never displays a wrong tile
    (master/main.go:153-161)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from distributed_raytracer.parallel import render_sharded_bvh
    mesh = jax.make_mesh((8,), (render_sharded_bvh.AXIS,))
    render = render_sharded_bvh.make_sharded_culled_renderer(
        tetra_scene, 40, 32, mesh=mesh, margin=1.0)
    before = render.buckets()
    close = tetra_scene.camera.move(2.4, forward=True)
    out = render(close, verify=True)
    # Counts recorded for the verified frame fit the (possibly re-sized)
    # buckets, and the image matches the dense path exactly.
    got = render.last_counts
    pads = render.buckets()                     # (w1, w, w1_sh, w_sh)
    assert all(int(got[:, k].max()) <= pads[k] for k in range(4))
    from distributed_raytracer.ops.render import render_frame
    dense = np.asarray(render_frame(render.band.arrays_host,
                                    close.to_arrays(), 40, 32))
    np.testing.assert_allclose(out, dense, atol=2e-5)
    del before


def test_sharded_bounced_matches_single(suzanne_scene):
    """Multi-chip multi-bounce == single-chip multi-bounce (depth 1)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    from distributed_raytracer.ops.render_bvh import CulledRenderer
    from distributed_raytracer.parallel import render_sharded_bvh
    w, h = 64, 48
    mesh = jax.make_mesh((8,), (render_sharded_bvh.AXIS,))
    render = render_sharded_bvh.make_sharded_bounced_renderer(
        suzanne_scene, w, h, depth=1, mesh=mesh)
    multi = render(suzanne_scene.camera)
    assert multi.shape == (h, w, 3)

    single = CulledRenderer(suzanne_scene, w, h)
    ref = np.asarray(single.render_bounced(suzanne_scene.camera, depth=1))
    diff = np.abs(multi - ref).max(-1)
    assert (diff > 2 / 255).mean() < 0.005
    assert np.abs(multi - ref).mean() < 1e-3
