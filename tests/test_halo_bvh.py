"""BVH-culled geometry-sharded renderer vs the replicated paths (8-dev CPU).

The culled halo schedule (parallel/halo_bvh.py) must be image-exact against
the replicated renderers: per-shard interval culling is conservative and the
(t, then global-id) fold is associative, so any pixel difference beyond the
usual BARY_EPS tie pixels is a bug. It must ALSO schedule far less work than
the dense sharded paths — that is its entire reason to exist (round-1
verdict item 1: pruning must apply to every query, like the reference's
two-level R-trees, object.go:76)."""

import jax
import numpy as np
import pytest

from distributed_raytracer.ops.render import render_frame
from distributed_raytracer.ops.render_bvh import CulledRenderer
from distributed_raytracer.parallel import halo_bvh
from distributed_raytracer.utils import scenes as S


@pytest.fixture(scope="module")
def mesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jax.make_mesh((8,), (halo_bvh.AXIS,))


def test_halo_bvh_matches_dense_tetra(tetra_scene, mesh8):
    w, h = 64, 48
    dense = np.asarray(render_frame(
        jax.device_put(tetra_scene.bake()), tetra_scene.camera.to_arrays(),
        w, h))
    r = halo_bvh.HaloCulledRenderer(tetra_scene, w, h, mesh=mesh8)
    out = r.render(tetra_scene.camera)
    np.testing.assert_allclose(out, dense, atol=2e-5)


def test_halo_bvh_matches_dense_suzanne(suzanne_scene, mesh8):
    w, h = 64, 48
    dense = np.asarray(render_frame(
        jax.device_put(suzanne_scene.bake()),
        suzanne_scene.camera.to_arrays(), w, h))
    r = halo_bvh.HaloCulledRenderer(suzanne_scene, w, h, mesh=mesh8)
    out = r.render(suzanne_scene.camera)
    diff = np.abs(out - dense).max(-1)
    assert (diff > 2 / 255).mean() < 0.005
    assert np.abs(out - dense).mean() < 1e-3


def test_halo_bvh_matches_culled_instanced(suzanne_scene, mesh8):
    """A 16-instance scene (~15K tris): the sharded-culled image must match
    the single-chip culled image, and the scheduled pair count must be a
    small fraction of the dense sharded schedule's rays x T."""
    big = S.instanced_grid(suzanne_scene, 4)
    w, h = 192, 128
    single = CulledRenderer(big, w, h)
    ref = np.asarray(single.render(big.camera, block=True))
    r = halo_bvh.HaloCulledRenderer(big, w, h, mesh=mesh8)
    out = r.render(big.camera, verify=True)
    diff = np.abs(out - ref).max(-1)
    assert (diff > 2 / 255).mean() < 0.005

    # Work-reduction: the dense sharded paths schedule rays x T always.
    # (24x at this size; the ratio grows with resolution — 96x64 tiles span
    # too much frustum for tight hulls, production sizes cull harder.)
    dense_pairs = r.n_pad_ext * r.nb_ext * r.tb
    assert r.scheduled_pairs() < dense_pairs / 15, (
        r.scheduled_pairs(), dense_pairs)


def test_halo_bvh_overflow_refreeze(tetra_scene, mesh8):
    """A camera far outside the sizing pose must trigger a re-size (not
    wrong pixels) under verify=True."""
    w, h = 64, 48
    r = halo_bvh.HaloCulledRenderer(tetra_scene, w, h, mesh=mesh8,
                                    margin=1.0)
    # Move close to the geometry: retention rises, buckets overflow.
    close = tetra_scene.camera.move(2.4, forward=True)
    out = r.render(close, verify=True)
    dense = np.asarray(render_frame(
        jax.device_put(tetra_scene.bake()), close.to_arrays(), w, h))
    np.testing.assert_allclose(out, dense, atol=2e-5)
    # After verify the recorded counts fit the (possibly re-sized) buckets.
    assert int(r.last_counts[:, 0].max()) <= r.w_pad
    assert int(r.last_counts[:, 1].max()) <= r.w_pad_sh


def test_halo_bvh_dynamic_diff(two_tetra_scene, mesh8):
    """Per-frame SceneDiff on the geometry-sharded halo path: move an
    object and a light each frame; the sharded image must match a dense
    render of a from-scratch re-bake (environment.go:73-98 — every worker
    applies every diff, whatever the topology)."""
    import copy

    scene = two_tetra_scene
    w, h = 96, 64
    r = halo_bvh.HaloCulledRenderer(scene, w, h, mesh=mesh8, dynamic=True,
                                    margin=4.0)
    for k in range(2):
        moved = copy.deepcopy(scene)
        moved.set_object_pos(2, [-1.6 + 0.5 * (k + 1), 0.4, -0.8 - 0.3 * k])
        moved.light_pos = moved.light_pos.copy()
        moved.light_pos[0] = [3 - 1.2 * k, 4, 5 + 0.8 * k]
        want = np.asarray(render_frame(
            jax.device_put(moved.bake()), scene.camera.to_arrays(), w, h))
        got = np.asarray(r.render_dynamic(scene.camera, moved.make_diff(),
                                          verify=True))
        bad = (np.abs(got - want).max(-1) > 2 / 255).mean()
        assert bad < 0.005, f"frame {k}: {bad:.4f} mismatched"


def test_halo_bounces_exact_tetra(tetra_scene, mesh8):
    """Sharded geometry + reflection bounces: each bounce's rays leave
    their origin shard (gather/cull/fold round per bounce) and the result
    must equal the replicated multi-bounce image — BASELINE.json's
    "secondary-ray halo exchange" hard mode at depth 1, exact on the
    4-tri scene."""
    w, h = 64, 48
    single = CulledRenderer(tetra_scene, w, h)
    ref = np.asarray(single.render_bounced(tetra_scene.camera, depth=1,
                                           block=True))
    r = halo_bvh.HaloCulledRenderer(tetra_scene, w, h, mesh=mesh8, bounces=1)
    out = r.render(tetra_scene.camera, verify=True)
    assert r.last_counts.shape == (8, 2, 2)       # (n, B+1, 2)
    np.testing.assert_allclose(out, ref, atol=2e-5)


@pytest.mark.slow
def test_halo_bounces_match_replicated_suzanne(suzanne_scene, mesh8):
    """depth-2 halo bounces vs the replicated render_bounced on the real
    asset: bit-close outside the usual BARY_EPS tie pixels."""
    w, h = 64, 48
    single = CulledRenderer(suzanne_scene, w, h)
    ref = np.asarray(single.render_bounced(suzanne_scene.camera, depth=2,
                                           block=True))
    r = halo_bvh.HaloCulledRenderer(suzanne_scene, w, h, mesh=mesh8, bounces=2)
    out = r.render(suzanne_scene.camera)
    diff = np.abs(out - ref).max(-1)
    assert (diff > 2 / 255).mean() < 0.005
    assert np.abs(out - ref).mean() < 1e-3


@pytest.mark.slow
def test_halo_local_hierarchy_matches_flat(suzanne_scene, mesh8):
    """The per-shard superblock level (local_levels=2, auto-enabled above
    ~1024 resident blocks) must be image-identical to the flat per-shard
    cull — the local unions are the same conservative interval math, and
    the shard padding keeps groups from straddling shards."""
    w, h = 64, 48
    flat = halo_bvh.HaloCulledRenderer(suzanne_scene, w, h, mesh=mesh8, local_levels=1)
    want = flat.render(suzanne_scene.camera, verify=True)
    hier = halo_bvh.HaloCulledRenderer(suzanne_scene, w, h, mesh=mesh8, local_levels=2,
                                       local_group=2)
    assert hier.loc_groups == (2,)
    got = hier.render(suzanne_scene.camera, verify=True)
    assert hier.last_counts.shape == (8, 4)     # per-level: (p0,p1,s0,s1)
    np.testing.assert_array_equal(got, want)
    # Bounces through the hierarchy too.
    fb = halo_bvh.HaloCulledRenderer(suzanne_scene, w, h, mesh=mesh8, bounces=1,
                                     local_levels=2, local_group=2)
    got_b = fb.render(suzanne_scene.camera, verify=True)
    ref_b = halo_bvh.HaloCulledRenderer(suzanne_scene, w, h, mesh=mesh8, bounces=1,
                                        local_levels=1)
    want_b = ref_b.render(suzanne_scene.camera, verify=True)
    np.testing.assert_array_equal(got_b, want_b)


def test_halo_bvh_dynamic_bounced(two_tetra_scene):
    """SceneDiff + bounces compose on the halo schedule: the diff folds
    into each shard's resident rows before bounce 0, and every bounce's
    gather/cull/fold sees updated geometry (tracer.go:81's one-core-every-
    topology, master/main.go:260-266's per-frame EnvMutables)."""
    import copy

    import jax

    from distributed_raytracer.ops.render import render_frame_bounced
    from distributed_raytracer.parallel import halo_bvh

    scene = two_tetra_scene
    w, h = 96, 64
    mesh = jax.make_mesh((8,), (halo_bvh.AXIS,))
    r = halo_bvh.HaloCulledRenderer(scene, w, h, mesh=mesh, dynamic=True,
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
