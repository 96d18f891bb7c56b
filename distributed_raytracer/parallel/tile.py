"""Screen partitioning.

Three partitioners live here:

1. `partition_bisect` — a faithful reimplementation of the master's recursive
   binary bisection (master/main.go:54-91): alternating split axis, 50x50
   minimum kernel, odd remainders to the right/bottom tile, worker budget
   divided by redundancy. Consumed by utils/oracle.render_oracle_tiles,
   which renders golden images tile-by-tile in the master's own WorkOrder
   rectangles (so tests can spot-check single tiles at a fraction of the
   full-frame oracle cost); the SPMD paths do not use it.

2. `row_partition` — the SPMD static partition: the ray grid is
   flattened and split into equal contiguous blocks, one per device in the
   mesh. The devices of a mesh are identical, so for uniform WORK an equal split
   is balanced by construction.

3. `balanced_rows` — the least-loaded-scheduler analog
   (master/pool/pool.go:148-197): chips are homogeneous but *work per
   screen region is not* (the band covering the model costs far more than
   sky bands), so the cost-balanced band renderer
   (parallel/render_sharded_bvh) measures per-tile-row cull work and
   partitions rows so each device's scheduled pairs are ~equal. The
   reference balances dynamically per order because its workers are
   heterogeneous AND elastic; SPMD work assignment must be static per
   compile, so the balance is computed at freeze time from measured costs
   and refreshed explicitly (render.rebalance) when the viewpoint drifts.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Tile:
    """A rectangular screen region (the WorkOrder analog, comms.proto:25-35)."""

    x: int
    y: int
    width: int
    height: int


def partition_bisect(width: int, height: int, workers: int,
                     redundancy: int = 1, width_kernel: int = 50,
                     height_kernel: int = 50) -> Tuple[List[Tile], int]:
    """Recursive bisection of the frame (master/main.go:54-91).

    Returns (tiles, leftover_workers). Split axis alternates (even depth =
    vertical cut); a dimension at or below its kernel stops splitting along
    it; odd pixels go to the right/bottom tile.
    """

    def rec(tile: Tile, workers: int, dimension: int):
        if workers // redundancy < 2:
            if workers > redundancy:
                return [tile], workers % redundancy
            return [tile], 0
        if tile.width <= width_kernel and tile.height <= height_kernel:
            return [tile], workers - redundancy
        elif tile.width <= width_kernel:
            dimension = 1
        elif tile.height <= height_kernel:
            dimension = 0

        if dimension % 2 == 0:
            left = Tile(tile.x, tile.y, tile.width // 2, tile.height)
            right = Tile(tile.x + tile.width // 2, tile.y,
                         tile.width // 2 + tile.width % 2, tile.height)
        else:
            left = Tile(tile.x, tile.y, tile.width, tile.height // 2)
            right = Tile(tile.x, tile.y + tile.height // 2,
                         tile.width, tile.height // 2 + tile.height % 2)

        l_tiles, rem = rec(left, workers // 2 + workers % 2, (dimension + 1) % 2)
        r_tiles, rem = rec(right, workers // 2 + rem, (dimension + 1) % 2)
        return l_tiles + r_tiles, rem

    return rec(Tile(0, 0, width, height), workers, 0)


def row_partition(n_rays: int, n_shards: int, chunk: int = 1) -> int:
    """Rays per shard for a static equal split, padded so each shard's count
    is a multiple of `chunk` (the lax.map chunk size)."""
    per = -(-n_rays // n_shards)
    return -(-per // chunk) * chunk


def balanced_rows(cost: Sequence[float], n: int,
                  cap: int) -> Tuple[List[int], List[int]]:
    """Contiguous partition of len(cost) rows into n groups, each at most
    `cap` rows, minimizing the maximum group cost (classic linear-partition
    DP, O(n * R^2) on R ~ tens of tile rows — host-side, freeze-time only).

    Returns (starts, rows): group b covers rows [starts[b], starts[b] +
    rows[b]). Empty groups are allowed (an all-sky frame end). `cap` bounds
    any one group so the band renderer's static height (and its per-device
    ray memory) stays bounded regardless of how skewed the costs are;
    callers pick cap >= ceil(R / n) so a partition always exists.
    """
    r = len(cost)
    if n * cap < r:
        raise ValueError(f"cap {cap} too small: {n} groups cannot cover "
                         f"{r} rows")
    prefix = [0.0]
    for c in cost:
        prefix.append(prefix[-1] + float(c))
    inf = float("inf")
    # dp[k][i]: minimal max group cost covering the first i rows with k
    # groups; choice[k][i]: the split point j of the optimum (group k =
    # rows [j, i)).
    dp = [[inf] * (r + 1) for _ in range(n + 1)]
    choice = [[0] * (r + 1) for _ in range(n + 1)]
    dp[0][0] = 0.0
    for k in range(1, n + 1):
        for i in range(r + 1):
            for j in range(max(0, i - cap), i + 1):
                if dp[k - 1][j] == inf:
                    continue
                v = max(dp[k - 1][j], prefix[i] - prefix[j])
                if v < dp[k][i]:
                    dp[k][i], choice[k][i] = v, j
    bounds = [r]
    i = r
    for k in range(n, 0, -1):
        i = choice[k][i]
        bounds.append(i)
    bounds.reverse()
    starts = bounds[:-1]
    rows = [bounds[b + 1] - bounds[b] for b in range(n)]
    return starts, rows
