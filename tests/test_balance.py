"""Cost-balanced band partition (the least-loaded-scheduler analog).

The reference's pool assigns each tile to the least-loaded worker
(master/pool/pool.go:148-197) because load varies; the SPMD analog is a
static split whose band HEIGHTS are sized from measured per-tile-row cull
work (parallel/tile.balanced_rows + render_sharded_bvh balanced mode).
These tests build a deliberately skewed frame — the object confined to one
equal-height band — and check that (a) the balanced split cuts the
max-band scheduled work by >= 2x and (b) the image is unchanged.
"""

import json

import jax
import numpy as np
import pytest

from distributed_raytracer.models import scene as scene_mod
from distributed_raytracer.parallel import tile as tile_mod


def test_balanced_rows_dp():
    # All cost in two adjacent rows: each lands in its own group.
    cost = [0, 0, 10, 12, 0, 0, 0, 0]
    starts, rows = tile_mod.balanced_rows(cost, 4, cap=4)
    assert sum(rows) == 8
    assert starts == sorted(starts)
    worst = max(sum(cost[s:s + r]) for s, r in zip(starts, rows))
    assert worst == 12                       # rows 2 and 3 split apart
    # Cap is respected even under extreme skew.
    starts, rows = tile_mod.balanced_rows([100] + [0] * 15, 4, cap=5)
    assert max(rows) <= 5 and sum(rows) == 16
    with pytest.raises(ValueError):
        tile_mod.balanced_rows([1] * 16, 2, cap=4)


@pytest.fixture(scope="module")
def skewed_scene(tmp_path_factory):
    """Tetra projected entirely inside equal band 1 of a 4-band 64x256
    frame: camera on -z axis, object ~0.2-0.8 slope above the view axis."""
    from tests.conftest import make_tetra_obj

    d = tmp_path_factory.mktemp("skew")
    make_tetra_obj(str(d / "tetra.obj"))
    p = d / "scene.json"
    p.write_text(json.dumps({
        "objs": [{"model": "tetra.obj",
                  "pos": {"x": 0.0, "y": 0.0, "z": 0.0}}],
        "lights": [{"pos": {"x": 3.0, "y": 4.0, "z": 5.0},
                    "col": {"r": 255, "g": 255, "b": 255}}],
        "cam": {"pos": {"x": 0.5, "y": -0.6, "z": 3.0},
                "dir": {"x": 0.0, "y": 0.0, "z": -1.0},
                "fov": 1.04719755},
    }))
    return scene_mod.load_scene(str(p))


def test_balanced_beats_equal_on_skew(skewed_scene):
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    from distributed_raytracer.ops.render import render_frame
    from distributed_raytracer.parallel import render_sharded_bvh
    w, h, n = 64, 256, 4
    mesh = jax.make_mesh((n,), (render_sharded_bvh.AXIS,),
                         devices=jax.devices()[:n])

    equal = render_sharded_bvh.make_sharded_culled_renderer(
        skewed_scene, w, h, mesh=mesh)
    img_eq = equal(skewed_scene.camera)
    eq_max = int(equal.last_counts[:, 1].max())      # fine cells, worst band

    bal = render_sharded_bvh.make_sharded_culled_renderer(
        skewed_scene, w, h, mesh=mesh, balance=True)
    img_bal = bal(skewed_scene.camera)
    bal_max = int(bal.last_counts[:, 1].max())

    # Sanity: the scene IS skewed — one equal band carries essentially all
    # primary work.
    eq_cells = equal.last_counts[:, 1]
    assert eq_max >= 0.8 * eq_cells.sum()
    # The balanced split spreads that band's rows across devices.
    assert bal_max * 2 <= eq_max, (bal_max, eq_max,
                                   bal.layout(), eq_cells.tolist())

    # No image change: both match the dense single-chip render.
    dense = np.asarray(render_frame(equal.band.arrays_host,
                                    skewed_scene.camera.to_arrays(), w, h))
    np.testing.assert_allclose(img_eq, dense, atol=2e-5)
    np.testing.assert_allclose(img_bal, dense, atol=2e-5)


def test_balanced_rebalance_and_verify(skewed_scene):
    """Moving the camera shifts work between rows; rebalance() re-probes
    and updates offsets without recompiling, and verify catches bucket
    overflow after the move."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    from distributed_raytracer.ops.render import render_frame
    from distributed_raytracer.parallel import render_sharded_bvh
    w, h, n = 64, 256, 4
    mesh = jax.make_mesh((n,), (render_sharded_bvh.AXIS,),
                         devices=jax.devices()[:n])
    bal = render_sharded_bvh.make_sharded_culled_renderer(
        skewed_scene, w, h, mesh=mesh, balance=True,
        margin=1.0)
    moved = skewed_scene.camera.move(1.2, forward=True)
    bal.rebalance(moved)
    out = bal(moved, verify=True)
    dense = np.asarray(render_frame(bal.band.arrays_host,
                                    moved.to_arrays(), w, h))
    np.testing.assert_allclose(out, dense, atol=2e-5)
