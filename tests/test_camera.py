"""Camera frame math vs shared/state/camera.go semantics."""

import math

import numpy as np
import pytest

from distributed_raytracer.models.camera import Camera, GLOBAL_UP


def test_create_frame():
    cam = Camera.create([1, 1, 5], [0, 0, -1], 1.04719755)
    # left = dir x GlobalUp; for -z forward that is +x (camera.go:40-42)
    assert np.allclose(cam.forward, [0, 0, -1])
    assert np.allclose(cam.left, [1, 0, 0])
    assert np.allclose(cam.up, [0, 1, 0])


def test_create_rejects_parallel_up():
    with pytest.raises(ValueError):
        Camera.create([0, 0, 0], [0, 1, 0], 1.0)
    with pytest.raises(ValueError):
        Camera.create([0, 0, 0], [0, -2, 0], 1.0)


def test_create_normalizes():
    cam = Camera.create([0, 0, 0], [0, 0, -9], 1.0)
    assert np.allclose(cam.forward, [0, 0, -1])


def test_move_directions():
    cam = Camera.create([0, 0, 0], [0, 0, -1], 1.0)
    assert np.allclose(cam.move(0.1, forward=True).pos, [0, 0, -0.1])
    assert np.allclose(cam.move(0.1, leftward=True).pos, [0.1, 0, 0])
    assert np.allclose(cam.move(0.1, upward=True).pos, [0, 0.1, 0])
    # Diagonal moves are normalized (camera.go:88-91).
    diag = cam.move(0.1, forward=True, leftward=True).pos
    assert np.allclose(np.linalg.norm(diag), 0.1)
    # Opposing directions cancel (camera.go:66-86).
    assert np.allclose(cam.move(0.1, forward=True, backward=True).pos, [0, 0, 0])


def test_yaw_quarter_turn():
    cam = Camera.create([0, 0, 0], [0, 0, -1], 1.0)
    c2 = cam.yaw(math.pi / 2)
    # Rotating about up=+y by +pi/2: -z -> -x (Rodrigues, vector.go:39-42).
    assert np.allclose(c2.forward, [-1, 0, 0], atol=1e-12)
    assert np.allclose(c2.left, np.cross(c2.forward, GLOBAL_UP), atol=1e-12)
    # Frame stays orthonormal.
    assert abs(c2.forward @ c2.left) < 1e-12
    assert abs(c2.forward @ c2.up) < 1e-12


def test_yaw_multiple_of_two_pi_is_noop():
    cam = Camera.create([0, 0, 0], [0.3, 0.2, -1], 1.0)
    c2 = cam.yaw(0.0)
    assert np.array_equal(c2.forward, cam.forward)


def test_pitch():
    cam = Camera.create([0, 0, 0], [0, 0, -1], 1.0)
    c2 = cam.pitch(math.pi / 4)
    # left = +x; rotating -z about +x by +pi/4 tips the view upward (+y).
    assert c2.forward[1] > 0
    assert np.allclose(np.linalg.norm(c2.forward), 1.0)
    assert abs(c2.forward @ c2.up) < 1e-12


def test_gimbal_nudge_deterministic():
    cam = Camera.create([0, 0, 0], [1, 0, 0], 1.0)
    # Pitch to exactly straight up, then yaw triggers the nudge guard.
    c2 = cam.pitch(-math.pi / 2)  # rotate about left=(0,0,1): +x -> +y?
    # Whichever sign convention, after pitching to vertical a yaw must not
    # produce NaNs and must stay orthonormal (camera.go:134-145).
    c3 = c2.yaw(0.5)
    assert np.all(np.isfinite(c3.forward))
    assert abs(np.linalg.norm(c3.forward) - 1.0) < 1e-9
    assert abs(c3.forward @ c3.left) < 1e-9
    # Determinism: same inputs -> same frame (divergence note in camera.py).
    c3b = c2.yaw(0.5)
    assert np.array_equal(c3.forward, c3b.forward)


def test_drift_free_yaw():
    cam = Camera.create([0, 0, 0], [0.3, 0.1, -1], 1.0)
    for _ in range(1000):
        cam = cam.yaw(0.013)
    assert abs(np.linalg.norm(cam.forward) - 1.0) < 1e-12
    assert abs(np.linalg.norm(cam.left) - 1.0) < 1e-12
    assert abs(cam.forward @ cam.left) < 1e-9
