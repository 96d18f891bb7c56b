"""Block-sparse traversal: the Triton kernels (interpret mode) against the
plain-XLA traversal, the XLA traversal against the dense intersector, the
route chooser and the run-bounds helper."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from distributed_raytracer.ops import cull, intersect, raygen
from distributed_raytracer.ops.pallas import bsr_trace as bt
from distributed_raytracer.utils import scenes

W, H = 96, 72                 # 216 ray tiles of 32 rays
TILE_W, TILE_H = 8, 4
RT = TILE_W * TILE_H
LONG_LIST = 16385             # items: more than one call of the former kernels took


@pytest.fixture(scope="module")
def baked():
    """icosphere(3) (1,280 tris) baked at each leaf size, plus its camera."""
    scene = scenes.icosphere_scene(3)
    out = {}
    for tb in (16, 64):
        arrays, tree = scene.bake_bvh(block_size=tb)
        out[tb] = (jnp.asarray(bt.pack_tris(arrays)),
                   jnp.asarray(tree.block_lo), jnp.asarray(tree.block_hi))
    return out, scene.camera.to_arrays()


def _rays(cam, shared: bool, kind: str):
    perm, _, n_slots = cull.tiled_ray_order(W, H, TILE_W, TILE_H)
    d_rows = raygen.ray_rows_flat(cam, W, H, jnp.asarray(perm))
    rng = np.random.default_rng(1)
    if shared:
        origin = cam.pos
    else:
        jitter = rng.uniform(-0.05, 0.05, (3, n_slots)).astype(np.float32)
        origin = cam.pos[:, None] + jnp.asarray(jitter)
    t_max = None
    if kind == "any":
        t_max = jnp.asarray(rng.uniform(1.5, 4.0, n_slots).astype(np.float32))
    return bt.pack_rays_rows(origin, d_rows, t_max)


def _work_list(rays, blo, bhi, case: str, kind: str):
    ti = cull.tile_intervals_packed(rays, RT, use_tmax=(kind == "any"))
    mask, entry = cull.block_mask_with_entry(ti, blo, bhi)
    if case == "empty_runs":                   # every other tile: no items
        mask = mask & (jnp.arange(mask.shape[0]) % 2 == 0)[:, None]
    if case == "long_list":                    # every (tile, block) pair
        mask = jnp.ones_like(mask)
    count = int(mask.sum())
    w_pad = bt.bucket_w_pad(count) + (3 if case == "empty_runs" else 0)
    wl = cull.compact_worklist(mask, w_pad, entry=entry)
    tile_ids, block_ids = wl.tile_ids, wl.block_ids
    if case == "long_list":
        # Replayed items are idempotent; they stretch the list past what
        # one call of the former segmented kernels took.
        reps = -(-LONG_LIST // count)
        tile_ids, block_ids = (jnp.repeat(a[:count], reps)
                               for a in (tile_ids, block_ids))
        count = tile_ids.shape[0] - 5          # a few padding items too
        assert count >= LONG_LIST
    return tile_ids, block_ids, jnp.int32(count)


@pytest.mark.parametrize("case", ["empty_runs", "init_carry", "gid_base",
                                  "exclusions", "long_list"])
@pytest.mark.parametrize("tb", [16, 64])
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per_ray"])
@pytest.mark.parametrize("kind", ["nearest", "any"])
def test_kernel_matches_xla_traversal(baked, kind, shared, tb, case):
    packs, cam = baked
    tris16, blo, bhi = packs[tb]
    rays = _rays(cam, shared, kind)
    r = rays.shape[1]
    tris = bt.pack_tris_origin(tris16, cam.pos) if shared else tris16
    tile_ids, block_ids, count = _work_list(rays, blo, bhi, case, kind)
    rng = np.random.default_rng(2)
    exclude = jnp.full((r,), -1, jnp.int32)
    gid_base = 1000 if case == "gid_base" else None
    kw = dict(rt=RT, tb=tb, shared_origin=shared)
    args = (rays, exclude, tris, tile_ids, block_ids, count)
    if case == "exclusions":                   # each even ray's own nearest
        _, near = bt.nearest_xla(*args, rt=RT, tb=tb, shared_origin=shared)
        exclude = jnp.where(jnp.arange(r) % 2 == 0, near, -1)
        args = (rays, exclude) + args[2:]

    if kind == "nearest":
        init = {}
        if case == "init_carry":
            init_t = np.where(rng.random(r) < 0.5,
                              rng.uniform(2.0, 3.0, r), np.inf)
            init = dict(init_t=jnp.asarray(init_t, jnp.float32),
                        init_i=jnp.asarray(rng.integers(0, 5000, r),
                                           jnp.int32))
        want_t, want_i = bt.nearest_xla(*args, gid_base=gid_base, **init, **kw)
        got_t, got_i = bt.nearest_pallas(*args, gid_base=gid_base, **init,
                                         interpret=True, **kw)
        want_t, want_i, got_t, got_i = map(np.asarray,
                                           (want_t, want_i, got_t, got_i))
        hit = np.isfinite(want_t)
        assert hit.any() and not hit.all()
        np.testing.assert_array_equal(np.isfinite(got_t), hit)
        np.testing.assert_allclose(got_t[hit], want_t[hit], rtol=1e-6)
        np.testing.assert_array_equal(got_i[hit], want_i[hit])
        if case == "init_carry":               # untouched rays keep init
            np.testing.assert_array_equal(got_i[~hit], want_i[~hit])
    else:
        init = None
        if case == "init_carry":
            init = jnp.asarray(rng.random(r) < 0.3, jnp.int32)
        want = np.asarray(bt.any_xla(*args, init=init, gid_base=gid_base,
                                     **kw))
        got = np.asarray(bt.any_pallas(*args, init=init, gid_base=gid_base,
                                       interpret=True, **kw))
        assert 0 < want.sum() < r
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per_ray"])
@pytest.mark.parametrize("scene_name", ["tetra_scene", "two_tetra_scene"])
def test_xla_traversal_matches_dense(request, scene_name, shared):
    """A full (tile, block) work list through the XLA traversal gives the
    dense intersector's nearest hits and shadow answers."""
    scene = request.getfixturevalue(scene_name)
    arrays, tree = scene.bake_bvh(block_size=16)
    cam = scene.camera.to_arrays()
    w, h = 48, 36
    perm, _, n_slots = cull.tiled_ray_order(w, h, TILE_W, TILE_H)
    d_rows = raygen.ray_rows_flat(cam, w, h, jnp.asarray(perm))
    if shared:
        origin, tris = cam.pos, bt.pack_tris_origin(
            jnp.asarray(bt.pack_tris(arrays)), cam.pos)
    else:
        rng = np.random.default_rng(3)
        origin = cam.pos[:, None] + jnp.asarray(
            rng.uniform(-0.1, 0.1, (3, n_slots)).astype(np.float32))
        tris = jnp.asarray(bt.pack_tris(arrays))
    t_max = jnp.full((n_slots,), 3.5, jnp.float32)
    rays = bt.pack_rays_rows(origin, d_rows, t_max)
    nt, nb = n_slots // RT, tree.num_blocks
    tile_ids = jnp.repeat(jnp.arange(nt, dtype=jnp.int32), nb)
    block_ids = jnp.tile(jnp.arange(nb, dtype=jnp.int32), nt)
    exclude = jnp.full((n_slots,), -1, jnp.int32)
    kw = dict(rt=RT, tb=16, shared_origin=shared)
    got_t, got_i = bt.nearest_xla(rays, exclude, tris, tile_ids, block_ids,
                                  **kw)
    got_any = bt.any_xla(rays, exclude, tris, tile_ids, block_ids, **kw)

    o_rows = jnp.broadcast_to(origin[:, None], (3, n_slots)) if shared \
        else origin
    dense = intersect.nearest_hit(arrays, o_rows.T, d_rows.T)
    dense_any = intersect.any_hit(arrays, o_rows.T, d_rows.T, t_max)
    hit = np.asarray(dense.valid)
    assert hit.any() and not hit.all()
    np.testing.assert_array_equal(np.isfinite(np.asarray(got_t)), hit)
    np.testing.assert_allclose(np.asarray(got_t)[hit],
                               np.asarray(dense.t)[hit], rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(got_i)[hit],
                                  np.asarray(dense.tri)[hit])
    np.testing.assert_array_equal(np.asarray(got_any) == 1,
                                  np.asarray(dense_any))


@pytest.mark.parametrize("backend,route", [("cpu", "xla"), ("gpu", "pallas"),
                                           ("rocm", None), ("metal", None)])
def test_traversal_route(monkeypatch, backend, route):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    if route is None:
        with pytest.raises(RuntimeError, match=backend):
            bt.traversal_route()
    else:
        assert bt.traversal_route() == route


def test_traversal_route_here_is_xla():
    assert bt.traversal_route() == "xla"


@pytest.mark.parametrize("tile_ids,count,n_tiles,want", [
    ([0, 0, 2, 2, 2, 2], 5, 4, [0, 2, 2, 5, 5]),   # empty tiles 1 and 3
    ([1, 1, 1, 1], 2, 3, [0, 0, 2, 2]),            # padding past count
    ([3, 3, 3], 0, 4, [0, 0, 0, 0, 0]),            # nothing real
    ([0, 1, 2, 3], 4, 4, [0, 1, 2, 3, 4]),
])
def test_tile_offsets(tile_ids, count, n_tiles, want):
    got = bt.tile_offsets(jnp.asarray(tile_ids, jnp.int32), count, n_tiles)
    np.testing.assert_array_equal(np.asarray(got), want)


@pytest.mark.parametrize("tile_ids,count,n_tiles,seg", [
    ([0, 0, 0, 0, 0, 2, 2, 3], 8, 5, 2),
    ([1] * 37 + [4] * 3, 39, 6, 16),
    ([0, 1, 2, 3], 0, 4, 4),
])
def test_tile_segments_cover_runs(tile_ids, count, n_tiles, seg):
    """Segments cut every tile's run into pieces of at most `seg` items,
    in order, and unused segments are empty."""
    got = np.asarray(bt.tile_segments(jnp.asarray(tile_ids, jnp.int32),
                                      count, n_tiles, seg))
    start, end, tile = got
    assert got.shape[1] == len(tile_ids) // seg + min(n_tiles, len(tile_ids))
    assert np.all(end - start <= seg) and np.all(end >= start)
    for t in range(n_tiles):
        items = [i for i in range(count) if tile_ids[i] == t]
        mine = [(a, b) for a, b, u in zip(start, end, tile) if u == t and b > a]
        covered = [i for a, b in mine for i in range(a, b)]
        assert covered == items
    assert (end > start).sum() == sum(
        -(-tile_ids[:count].count(t) // seg) for t in range(n_tiles))


@pytest.mark.parametrize("n,want", [(1, 256), (300, 512), (2048, 2048),
                                    (2049, 4096), (40000, 40960)])
def test_bucket_w_pad(n, want):
    assert bt.bucket_w_pad(n) == want


def test_lights_origin_packs_stacks_per_light():
    rng = np.random.default_rng(4)
    tris = jnp.asarray(rng.normal(size=(32, 16)).astype(np.float32))
    lights = jnp.asarray(rng.normal(size=(3, 3)).astype(np.float32))
    got = np.asarray(bt.lights_origin_packs(tris, lights))
    assert got.shape == (96, 16)
    for li in range(3):
        np.testing.assert_array_equal(
            got[li * 32:(li + 1) * 32],
            np.asarray(bt.pack_tris_origin(tris, lights[li])))
    assert bt.lights_origin_packs(tris, lights[:0]).shape == (0, 16)
