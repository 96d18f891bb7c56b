"""Block BVH, culling, and culled-renderer tests (XLA traversal on CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from distributed_raytracer.models import bvh as bvh_mod
from distributed_raytracer.ops import cull, intersect, raygen
from distributed_raytracer.ops.render import render_frame
from distributed_raytracer.ops.render_bvh import CulledRenderer


# ---- builder ----------------------------------------------------------------

def test_morton_codes_locality():
    pts = np.array([[0, 0, 0], [0.01, 0, 0], [1, 1, 1]], dtype=np.float64)
    codes = bvh_mod.morton_codes(pts)
    assert abs(int(codes[0]) - int(codes[1])) < abs(int(codes[0]) - int(codes[2]))


def test_block_bvh_bounds_contain_tris(suzanne_scene):
    arrays, tree = suzanne_scene.bake_bvh(block_size=128)
    n_real = suzanne_scene.num_tris
    p0 = np.asarray(arrays.p0, np.float64)[:n_real]
    p1 = p0 + np.asarray(arrays.e1, np.float64)[:n_real]
    p2 = p0 + np.asarray(arrays.e2, np.float64)[:n_real]
    for b in range(tree.num_blocks):
        lo, hi = tree.block_lo[b], tree.block_hi[b]
        s = slice(b * 128, min((b + 1) * 128, n_real))
        if s.start >= n_real:
            assert np.all(lo > hi)  # pure-padding block: inverted AABB
            continue
        for v in (p0[s], p1[s], p2[s]):
            assert np.all(v >= lo[None, :] - 1e-4)
            assert np.all(v <= hi[None, :] + 1e-4)


def test_reorder_preserves_image(suzanne_scene):
    """Morton reordering must not change the rendered image."""
    plain = render_frame(suzanne_scene.bake(), suzanne_scene.camera.to_arrays(), 48, 36)
    arrays, _ = suzanne_scene.bake_bvh()
    sorted_img = render_frame(arrays, suzanne_scene.camera.to_arrays(), 48, 36)
    np.testing.assert_allclose(np.asarray(plain), np.asarray(sorted_img), atol=2e-5)


# ---- culling ----------------------------------------------------------------

def test_block_mask_is_conservative(suzanne_scene):
    """Every actual per-ray hit must come from a block the mask kept."""
    arrays, tree = suzanne_scene.bake_bvh(block_size=128)
    cam = suzanne_scene.camera.to_arrays()
    w, h, rt = 64, 48, 128
    idx = jnp.arange(-(-w * h // rt) * rt, dtype=jnp.int32)
    dirs = raygen.ray_directions_flat(cam, w, h, idx)
    ti = cull.tile_intervals(cam.pos, dirs, rt)
    mask = np.asarray(cull.block_mask(ti, jnp.asarray(tree.block_lo),
                                      jnp.asarray(tree.block_hi)))
    hits = intersect.nearest_hit(arrays, jnp.asarray(cam.pos), dirs)
    tri = np.asarray(hits.tri)
    valid = np.asarray(hits.valid)
    tiles = np.arange(len(tri)) // rt
    blocks = tri // 128
    for k in np.where(valid)[0]:
        assert mask[tiles[k], blocks[k]], (tiles[k], blocks[k])
    # And it must actually cull something.
    assert mask.mean() < 0.9


def test_compact_worklist_structure():
    mask = jnp.asarray(np.array([[0, 1, 0], [0, 0, 0], [1, 0, 1]], bool))
    wl = cull.compact_worklist(mask, 8)
    assert int(wl.count) == 3
    np.testing.assert_array_equal(np.asarray(wl.tile_ids)[:3], [0, 2, 2])
    np.testing.assert_array_equal(np.asarray(wl.block_ids)[:3], [1, 0, 2])
    # Padding repeats the last entry.
    np.testing.assert_array_equal(np.asarray(wl.tile_ids)[3:], [2] * 5)
    np.testing.assert_array_equal(np.asarray(wl.block_ids)[3:], [2] * 5)


def test_compact_worklist_front_to_back():
    mask = jnp.asarray(np.array([[1, 1, 1], [0, 1, 1]], bool))
    entry = jnp.asarray(np.array([[5.0, 1.0, 3.0], [9.0, 8.0, 2.0]]))
    wl = cull.compact_worklist(mask, 8, entry=entry)
    assert int(wl.count) == 5
    # Tiles stay grouped/ascending; blocks sorted by entry within each tile.
    np.testing.assert_array_equal(np.asarray(wl.tile_ids)[:5], [0, 0, 0, 1, 1])
    np.testing.assert_array_equal(np.asarray(wl.block_ids)[:5], [1, 2, 0, 2, 1])
    np.testing.assert_array_equal(np.asarray(wl.entry)[:5], [1, 3, 5, 2, 8])


def test_compact_worklist_empty():
    wl = cull.compact_worklist(jnp.zeros((4, 4), bool), 4)
    assert int(wl.count) == 0


# ---- end-to-end culled renderer --------------------------------------------

def test_culled_matches_dense_tetra(tetra_scene):
    w, h = 64, 48
    dense = np.asarray(render_frame(tetra_scene.bake(),
                                    tetra_scene.camera.to_arrays(), w, h))
    r = CulledRenderer(tetra_scene, w, h)
    culled = np.asarray(r.render(tetra_scene.camera))
    np.testing.assert_allclose(culled, dense, atol=2e-5)


def test_culled_matches_dense_suzanne(suzanne_scene):
    """Culled == dense on the same (Morton) triangle order.

    At these resolutions Suzanne's triangles are sub-pixel, so nearly every
    pixel involves a shared-edge tie; comparing against a different triangle
    order would only measure tie-breaking. On identical arrays the paths
    must agree to fp noise."""
    w, h = 64, 48
    r = CulledRenderer(suzanne_scene, w, h)
    dense = np.asarray(render_frame(r.arrays_host, suzanne_scene.camera.to_arrays(), w, h))
    culled = np.asarray(r.render(suzanne_scene.camera))
    diff = np.abs(culled - dense).max(-1)
    assert (diff > 2 / 255).mean() < 0.005
    assert np.abs(culled - dense).mean() < 1e-4


def test_culled_moved_camera(suzanne_scene):
    w, h = 48, 36
    cam = suzanne_scene.camera.move(0.8, backward=True).yaw(0.3)
    r = CulledRenderer(suzanne_scene, w, h)
    dense = np.asarray(render_frame(r.arrays_host, cam.to_arrays(), w, h))
    culled = np.asarray(r.render(cam))
    diff = np.abs(culled - dense).max(-1)
    assert (diff > 2 / 255).mean() < 0.005


def test_culled_frozen_fast_path(tetra_scene):
    w, h = 48, 36
    r = CulledRenderer(tetra_scene, w, h)
    sync = np.asarray(r.render(tetra_scene.camera))
    r.freeze(tetra_scene.camera)
    fast = np.asarray(r.render_fast(tetra_scene.camera, verify=True))
    np.testing.assert_allclose(fast, sync, atol=2e-5)


def test_culled_offview_camera_is_black(tetra_scene):
    """Ray tiles with zero work-list entries must produce misses: the
    traversal writes their init value. Regression test for reads of
    unwritten outputs when the scene is (mostly) out of view."""
    from distributed_raytracer.models.camera import Camera

    w, h = 64, 48
    # Look almost exactly away from the object: a corner sliver at most.
    away = Camera.create(np.asarray(tetra_scene.camera.pos),
                         np.array([0.9, 0.3, 0.3]), tetra_scene.camera.fov)
    r = CulledRenderer(tetra_scene, w, h)
    dense = np.asarray(render_frame(tetra_scene.bake(), away.to_arrays(), w, h))
    culled = np.asarray(r.render(away))
    np.testing.assert_allclose(culled, dense, atol=2e-5)


# ---- inverted-padding rejection --------------------------------------------

def test_inverted_padding_boxes_never_pass():
    """The slab quotient math alone PASSES (+inf, -inf) inverted boxes
    (a=+inf/b=-inf spans every axis interval), so the masks must reject
    them explicitly — a passing phantom superblock member becomes an
    out-of-range block id and out-of-bounds reads in the traversal."""
    ti = cull.TileIntervals(
        o_lo=jnp.zeros((2, 3)), o_hi=jnp.zeros((2, 3)),
        d_lo=jnp.full((2, 3), -1.0), d_hi=jnp.ones((2, 3)),
        t_hi=jnp.full((2,), jnp.inf))
    blo = jnp.array([[-1.0, -1, -1], [jnp.inf] * 3])
    bhi = jnp.array([[1.0, 1, 1], [-jnp.inf] * 3])
    mask, _ = cull.block_mask_with_entry(ti, blo, bhi)
    assert bool(mask[0, 0]) and not bool(mask[:, 1].any())


def test_fine_worklist_block_ids_in_range():
    """nb not a multiple of cull_group: the last superblock's phantom
    members must never reach the work list (mask) nor exceed nb-1 (clamp)."""
    rng = np.random.default_rng(7)
    nb, group = 9, 4          # nsb=3, 3 phantom members in the tail
    blo = jnp.asarray(rng.uniform(-5, 4, (nb, 3)).astype(np.float32))
    bhi = blo + jnp.asarray(rng.uniform(0.5, 2, (nb, 3)).astype(np.float32))
    ti = cull.TileIntervals(
        o_lo=jnp.full((3, 3), -10.0), o_hi=jnp.full((3, 3), -10.0),
        d_lo=jnp.full((3, 3), 0.1), d_hi=jnp.ones((3, 3)),
        t_hi=jnp.full((3,), jnp.inf))
    mask1, entry1, c1 = cull.coarse_mask(ti, blo, bhi, group)
    wl, c2 = cull.fine_worklist(ti, mask1, entry1, c1, blo, bhi, group,
                                w1_pad=16, w_pad=64)
    assert int(wl.block_ids.max()) < nb
    # every real work item references an existing block
    ids = np.asarray(wl.block_ids)[: int(wl.count)]
    assert ids.size > 0 and ids.max() < nb


def test_verify_loops_until_counts_fit(suzanne_scene):
    """Freeze with a camera that sees almost nothing, then verify-render a
    camera that sees everything: the level-1 bucket overflows, so the
    level-2 counts of the first dispatch are undercounts — a single
    refreeze is not provably sufficient. The verify loop must converge to
    the exact sync-render image."""
    w, h = 48, 36
    r = CulledRenderer(suzanne_scene, w, h)
    away = suzanne_scene.camera.yaw(3.14159)       # scene behind the camera
    r.render(away, block=True)
    r.freeze(away, margin=1.0)                     # tiny buckets
    cam = suzanne_scene.camera
    fast = np.asarray(r.render_fast(cam, verify=True))
    sync = np.asarray(r.render(cam, block=True))
    np.testing.assert_allclose(fast, sync, atol=2e-5)
    # and the refrozen buckets now hold the true counts
    assert all(g <= p for g, p in zip(r._last_counts, r._frozen_pads))


def test_render_many_matches_fast(suzanne_scene):
    """The batched-dispatch path (one scan over staged cameras) must be
    image-identical to per-dispatch render_fast frames — it exists only to
    amortize host dispatch cost, never to change the math."""
    from distributed_raytracer.ops.render_bvh import CulledRenderer
    from distributed_raytracer.runtime import animation

    r = CulledRenderer(suzanne_scene, 64, 48)
    r.render(suzanne_scene.camera, block=True)
    r.freeze(suzanne_scene.camera)
    poses = animation.orbit_camera_path(suzanne_scene.camera, 3,
                                        radius=6.0, revolutions=0.05)
    cams = [p.to_arrays() for p in poses]
    imgs, counts = r.render_many(cams)
    assert np.asarray(counts).shape == (3, 5)
    for k, c in enumerate(cams):
        want = np.asarray(r.render_fast(c))
        np.testing.assert_array_equal(np.asarray(imgs[k]), want)


@pytest.mark.slow
def test_three_level_cull_matches_two_level(suzanne_scene):
    """The super-superblock hierarchy (cull_levels=3, auto-enabled on
    multi-million-triangle scenes) must be image-identical to the 2-level
    walk — every level's test is the same conservative interval math, so
    only the work changes. Exercised with tiny groups so the hierarchy is
    non-trivial even at 968 tris."""
    from distributed_raytracer.ops.render_bvh import CulledRenderer

    w, h = 64, 48
    r2 = CulledRenderer(suzanne_scene, w, h, cull_group=2,
                        cull_levels=2)
    want = np.asarray(r2.render(suzanne_scene.camera, block=True))
    r3 = CulledRenderer(suzanne_scene, w, h, cull_group=2,
                        cull_levels=3)
    assert len(r3.groups) == 2 and r3.n_levels == 3
    got = np.asarray(r3.render(suzanne_scene.camera, block=True))
    np.testing.assert_array_equal(got, want)
    assert len(r3._last_counts) == 7          # (c0, c1, c2, ht, s0, s1, s2)
    # frozen fast path + verify loop under 3 levels
    r3.freeze(suzanne_scene.camera)
    fast = np.asarray(r3.render_fast(suzanne_scene.camera.to_arrays(),
                                     verify=True))
    np.testing.assert_array_equal(fast, want)
    # bounce path under 3 levels
    b2 = np.asarray(r2.render_bounced(suzanne_scene.camera, depth=1,
                                      block=True))
    b3 = np.asarray(r3.render_bounced(suzanne_scene.camera, depth=1,
                                      block=True))
    np.testing.assert_array_equal(b3, b2)
