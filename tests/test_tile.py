"""Screen partitioner tests (master/main.go:54-91 semantics)."""

import numpy as np

from distributed_raytracer.parallel.tile import Tile, partition_bisect, row_partition


def coverage_map(tiles, width, height):
    cover = np.zeros((height, width), dtype=np.int32)
    for t in tiles:
        cover[t.y:t.y + t.height, t.x:t.x + t.width] += 1
    return cover


def test_exact_cover_reference_config():
    # The reference's benchmark config: 320x240, 24 workers.
    tiles, leftover = partition_bisect(320, 240, 24)
    cover = coverage_map(tiles, 320, 240)
    assert np.all(cover == 1)  # disjoint, complete
    assert len(tiles) + leftover <= 24
    assert len(tiles) <= 24


def test_single_worker_single_tile():
    tiles, leftover = partition_bisect(320, 240, 1)
    assert tiles == [Tile(0, 0, 320, 240)]
    assert leftover == 0


def test_kernel_floor():
    # With a huge worker pool, tiles stop splitting at the 50x50 kernel.
    tiles, _ = partition_bisect(200, 200, 4096)
    assert np.all(coverage_map(tiles, 200, 200) == 1)
    for t in tiles:
        assert t.width <= 50 and t.height <= 50


def test_odd_remainder_goes_right():
    tiles, _ = partition_bisect(101, 60, 2)
    assert sorted((t.x, t.width) for t in tiles) == [(0, 50), (50, 51)]


def test_redundancy_halves_budget():
    t1, _ = partition_bisect(320, 240, 24, redundancy=1)
    t2, _ = partition_bisect(320, 240, 24, redundancy=2)
    assert len(t2) <= len(t1)
    assert np.all(coverage_map(t2, 320, 240) == 1)


def test_row_partition_padding():
    per = row_partition(100, 8, chunk=16)
    assert per % 16 == 0
    assert per * 8 >= 100
    assert row_partition(64, 8, chunk=1) == 8


def test_oracle_renders_in_bisect_tiles(tetra_scene):
    """The oracle driven by the master's WorkOrder rectangles: full-frame
    tile-by-tile render == plain oracle render (every pixel covered exactly
    once), and a single tile renders only (and exactly) its region."""
    from distributed_raytracer.utils import oracle

    w, h = 48, 36
    full = oracle.render_oracle(tetra_scene, w, h)
    tiled, tiles = oracle.render_oracle_tiles(
        tetra_scene, w, h, workers=6, width_kernel=16, height_kernel=16)
    assert len(tiles) > 1
    np.testing.assert_array_equal(tiled, full)

    one, tiles = oracle.render_oracle_tiles(
        tetra_scene, w, h, workers=6, only=[0],
        width_kernel=16, height_kernel=16)
    t = tiles[0]
    np.testing.assert_array_equal(one[t.y:t.y + t.height, t.x:t.x + t.width],
                                  full[t.y:t.y + t.height, t.x:t.x + t.width])
    outside = one.copy()
    outside[t.y:t.y + t.height, t.x:t.x + t.width] = 0
    assert not outside.any()
