"""Multi-bounce specular reflection tests (the BASELINE config-2 extension)."""

import pytest
import numpy as np

from distributed_raytracer.ops.render import render_frame, render_frame_bounced
from distributed_raytracer.utils import oracle


def test_depth_zero_equals_primary(tetra_scene):
    arrays = tetra_scene.bake()
    cam = tetra_scene.camera.to_arrays()
    base = np.asarray(render_frame(arrays, cam, 48, 36))
    d0 = np.asarray(render_frame_bounced(arrays, cam, 48, 36, depth=0))
    np.testing.assert_allclose(d0, base, atol=1e-6)


def test_bounce_adds_light_on_specular(suzanne_scene):
    """Suzanne has Ks=0.5: bounced light must change (increase somewhere)
    the image, and everything stays in [0,1]."""
    arrays = suzanne_scene.bake()
    cam = suzanne_scene.camera.to_arrays()
    d0 = np.asarray(render_frame_bounced(arrays, cam, 64, 48, depth=0))
    d2 = np.asarray(render_frame_bounced(arrays, cam, 64, 48, depth=2))
    assert d2.min() >= 0.0 and d2.max() <= 1.0
    assert (d2 - d0).max() > 0.01      # some pixel gained reflected light
    assert (d2 >= d0 - 1e-5).all()     # throughput is non-negative


def test_bounced_matches_oracle(tetra_scene):
    w, h = 48, 36
    want = oracle.render_oracle_bounced(tetra_scene, w, h, depth=2)
    got = np.asarray(render_frame_bounced(tetra_scene.bake(),
                                          tetra_scene.camera.to_arrays(),
                                          w, h, depth=2))
    diff = np.abs(got - want).max(-1)
    # Bounced rays compound edge discontinuities; allow a slightly larger
    # outlier budget than the primary-ray golden tests.
    assert (diff > 3 / 255).mean() < 0.02
    assert np.abs(got - want).mean() < 0.01


def test_bounced_matches_oracle_suzanne(suzanne_scene):
    w, h = 48, 36
    want = oracle.render_oracle_bounced(suzanne_scene, w, h, depth=1)
    got = np.asarray(render_frame_bounced(suzanne_scene.bake(),
                                          suzanne_scene.camera.to_arrays(),
                                          w, h, depth=1))
    assert np.abs(got - want).mean() < 0.02


def test_culled_bounced_matches_dense(suzanne_scene):
    import jax
    from distributed_raytracer.ops.render_bvh import CulledRenderer
    w, h = 48, 36
    r = CulledRenderer(suzanne_scene, w, h)
    dense = np.asarray(render_frame_bounced(r.arrays_host,
                                            suzanne_scene.camera.to_arrays(),
                                            w, h, depth=2))
    culled = np.asarray(r.render_bounced(suzanne_scene.camera, depth=2))
    diff = np.abs(culled - dense).max(-1)
    assert (diff > 2 / 255).mean() < 0.01
    assert np.abs(culled - dense).mean() < 2e-3


def test_culled_bounced_depth0_equals_render(tetra_scene):
    import jax
    from distributed_raytracer.ops.render_bvh import CulledRenderer
    r = CulledRenderer(tetra_scene, 48, 36)
    base = np.asarray(r.render(tetra_scene.camera))
    d0 = np.asarray(r.render_bounced(tetra_scene.camera, depth=0))
    np.testing.assert_allclose(d0, base, atol=2e-5)


@pytest.mark.slow
def test_culled_bounced_frozen_matches_sync(tetra_scene):
    import jax
    from distributed_raytracer.ops.render_bvh import CulledRenderer
    r = CulledRenderer(tetra_scene, 48, 36)
    sync = np.asarray(r.render_bounced(tetra_scene.camera, depth=2))
    fast = r.freeze_bounced(tetra_scene.camera, depth=2)
    out = np.asarray(fast(tetra_scene.camera))
    np.testing.assert_allclose(out, sync, atol=2e-5)
