"""Golden-image tests: the jitted device-path renderer vs the float64 oracle.

The oracle (utils/oracle.py) is the executable spec of the reference's
sequential renderer. float32 and float64 can legitimately disagree at
*discontinuities* — triangle edges (which surface does the ray hit?) and
shadow terminators (is the blocker closer than the light?). Golden tests
therefore build a discontinuity mask from the oracle's per-pixel decisions
(hit id / lit flags changing within a 3x3 neighborhood) and require:
  - continuity pixels match within a tight per-channel tolerance, and
  - the whole image matches in the mean.
"""

import numpy as np

from distributed_raytracer.ops.render import render_frame
from distributed_raytracer.utils import oracle


def discontinuity_mask(aux) -> np.ndarray:
    """True where any decision (hit tri, lit flags) changes in the 3x3
    neighborhood — pixels where fp precision may flip the outcome."""
    tri = aux["tri"]
    lit = aux["lit"]
    h, w = tri.shape
    code = tri.astype(np.int64) + 1  # -1 (miss) -> 0
    for k in range(lit.shape[-1]):
        code = code * 2 + lit[..., k]
    mask = np.zeros((h, w), dtype=bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            shifted = np.roll(np.roll(code, dy, axis=0), dx, axis=1)
            mask |= shifted != code
    return mask


def assert_images_close(got, want, aux, channel_tol=3.0 / 255.0,
                        smooth_outlier_frac=0.002, mean_tol=0.01):
    got = np.asarray(got, dtype=np.float64)
    diff = np.abs(got - want).max(axis=-1)  # per-pixel max channel diff
    smooth = ~discontinuity_mask(aux)
    assert smooth.sum() > 0.2 * smooth.size, "mask degenerated; resolution too low"
    frac_bad = float((diff[smooth] > channel_tol).mean())
    assert frac_bad <= smooth_outlier_frac, (
        f"{frac_bad:.4%} of continuity pixels exceed tolerance "
        f"(max diff there {diff[smooth].max():.4f})")
    assert float(np.abs(got - want).mean()) <= mean_tol


def render_both(scene, w, h, camera=None):
    cam = camera if camera is not None else scene.camera
    want, aux = oracle.render_oracle(scene, w, h, camera=cam, return_aux=True)
    got = render_frame(scene.bake(), cam.to_arrays(), w, h)
    return got, want, aux


def test_tetra_matches_oracle(tetra_scene):
    got, want, aux = render_both(tetra_scene, 72, 54)
    assert_images_close(got, want, aux)
    # The scene must actually produce a non-trivial image.
    assert want.max() > 0.2
    assert (want.sum(axis=-1) > 0).mean() > 0.05  # some pixels hit


def test_suzanne_matches_oracle(suzanne_scene):
    got, want, aux = render_both(suzanne_scene, 96, 72)
    assert_images_close(got, want, aux)
    assert (want.sum(axis=-1) > 0).mean() > 0.05


def test_moved_camera_matches_oracle(tetra_scene):
    cam = tetra_scene.camera.move(0.5, backward=True).yaw(0.2).pitch(-0.1)
    got, want, aux = render_both(tetra_scene, 64, 48, camera=cam)
    assert_images_close(got, want, aux)


def test_render_odd_dimensions(tetra_scene):
    # Integer half-width semantics must not crash or misalign on odd sizes.
    got, want, aux = render_both(tetra_scene, 37, 23)
    assert got.shape == (23, 37, 3)
    assert_images_close(got, want, aux)


def test_background_is_black(tetra_scene):
    got = np.asarray(render_frame(tetra_scene.bake(),
                                  tetra_scene.camera.to_arrays(), 48, 36))
    corner = got[0, 0]  # camera aimed at the tetra center; corners miss
    assert np.all(corner == 0.0)
