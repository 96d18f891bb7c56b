"""Runtime layer: stats, controller, framebuffer, frame loop."""

import numpy as np
import pytest

from distributed_raytracer.models.camera import Camera
from distributed_raytracer.runtime import animation, framebuffer
from distributed_raytracer.runtime.controller import CameraController
from distributed_raytracer.runtime.loop import run_loop
from distributed_raytracer.runtime.stats import FrameTimer


# ---- stats (master/main.go:285-325) ---------------------------------------

def test_stats_cumulative_fps():
    timer = FrameTimer()
    for k in range(5):
        timer.frame_issued()
        timer.frame_drawn(at=k * 0.1)  # 10 FPS steady
    s = timer.stats()
    # Cumulative averages of a steady 10 FPS stream are all 10.
    assert s is not None
    assert np.allclose(s.fps_per_frame, 10.0)
    assert np.isclose(s.mean_fps, 10.0)
    assert np.isclose(s.median_fps, 10.0)
    assert np.isclose(s.stddev_fps, 0.0)
    assert s.frames_drawn == 5 and s.frames_total == 5


def test_stats_first_frame_dropped():
    timer = FrameTimer()
    # A slow first frame followed by fast ones: the reference drops the first
    # timestamp pair, so the slow start only shifts durations.
    for t in [0.0, 1.0, 1.1, 1.2]:
        timer.frame_drawn(at=t)
    s = timer.stats()
    assert len(s.fps_per_frame) == 3
    # fps_0 = 1 / 1.0s; fps_1 = 2 / 1.1; fps_2 = 3 / 1.2
    assert np.allclose(s.fps_per_frame, [1.0, 2 / 1.1, 3 / 1.2])
    # Go median = sorted[n/2] (upper median for even n? n=3 -> index 1).
    assert np.isclose(s.median_fps, 2 / 1.1)


def test_stats_insufficient_frames():
    timer = FrameTimer()
    timer.frame_drawn(at=0.0)
    assert timer.stats() is None


def test_stats_report_format():
    timer = FrameTimer()
    for k in range(3):
        timer.frame_issued()
        timer.frame_drawn(at=k * 0.5)
    rep = timer.stats().report()
    assert "Mean FPS" in rep and "Median FPS" in rep and "FPS Range" in rep


# ---- controller (input.go + master/main.go:246-258) ------------------------

def test_controller_opposing_keys_cancel():
    c = CameraController(width=320, height=240)
    c.key_down("w")
    assert c.move_dirs != 0
    c.key_down("s")  # opposing press clears both (input.go:47-52)
    assert c.move_dirs == 0


def test_controller_key_up():
    c = CameraController(width=320, height=240)
    c.key_down("a")
    c.key_up("a")
    assert c.move_dirs == 0 and not c.dirty


def test_controller_esc_stops():
    c = CameraController(width=320, height=240)
    c.key_down("esc")
    assert not c.running


def test_controller_mouse_units():
    # yaw in units of width/2, pitch negated in units of height/2 (input.go:98-102)
    c = CameraController(width=320, height=240)
    c.mouse_motion(160, -120)
    assert np.isclose(c._yaw, 1.0)
    assert np.isclose(c._pitch, 1.0)


def test_controller_apply_matches_master_scaling():
    cam = Camera.create([0, 0, 0], [0, 0, -1], 1.0)
    c = CameraController(width=320, height=240)
    c.mouse_motion(160, 0)  # yaw unit 1 -> rotation fov/2 = 0.5 rad
    cam2 = c.apply(cam)
    expected = cam.yaw(0.5)
    assert np.allclose(cam2.forward, expected.forward)
    assert not c.dirty  # deltas consumed


def test_controller_move_only_when_dirty():
    cam = Camera.create([0, 0, 0], [0, 0, -1], 1.0)
    c = CameraController(width=320, height=240)
    c.key_down("w")
    cam2 = c.apply(cam)
    assert np.allclose(cam2.pos, [0, 0, -0.1])  # move_step 0.1 (main.go:254)
    assert c.dirty  # key still held -> next frame moves again


# ---- framebuffer -----------------------------------------------------------

def test_ppm_roundtrip(tmp_path):
    img = np.random.default_rng(0).uniform(size=(7, 5, 3)).astype(np.float32)
    p = str(tmp_path / "x.ppm")
    framebuffer.write_ppm(p, img)
    back = framebuffer.read_ppm(p)
    assert np.array_equal(back, framebuffer.to_u8(img))


def test_png_valid_structure(tmp_path):
    import struct
    import zlib
    img = np.zeros((4, 6, 3), dtype=np.uint8)
    img[1, 2] = [255, 128, 0]
    p = str(tmp_path / "x.png")
    framebuffer.write_png(p, img)
    data = open(p, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    w, h = struct.unpack(">II", data[16:24])
    assert (w, h) == (6, 4)
    # decode IDAT and check the pixel survives
    idat_start = data.index(b"IDAT") + 4
    idat_len = struct.unpack(">I", data[idat_start - 8:idat_start - 4])[0]
    raw = zlib.decompress(data[idat_start:idat_start + idat_len])
    row1 = np.frombuffer(raw[(6 * 3 + 1) * 1 + 1:(6 * 3 + 1) * 2], dtype=np.uint8)
    assert row1.reshape(6, 3)[2].tolist() == [255, 128, 0]


# ---- frame loop ------------------------------------------------------------

def test_loop_renders_only_on_input(tetra_scene):
    arrays = tetra_scene.bake()
    calls = []

    def fake_render(scene, cam_arrays):
        calls.append(np.asarray(cam_arrays.pos))
        return np.zeros((4, 4, 3), dtype=np.float32)

    displayed = []
    events = [[], [("key_down", "w")], [], [("key_up", "w")], [], []]
    cam, stats, dropped = run_loop(
        arrays, tetra_scene.camera, fake_render, 32, 24,
        events=events, display=lambda i, img: displayed.append(i))
    # Ticks with w held: the key_down tick and the next tick; the key_up is
    # processed before the dirty check on its own tick (as HandleInputs does)
    # -> 2 frames.
    assert len(calls) == 2
    assert displayed == [0, 1]
    assert dropped == 0
    # Camera moved forward 2 * 0.1 along its forward vector.
    expected = tetra_scene.camera.pos + 0.2 * tetra_scene.camera.forward
    assert np.allclose(cam.pos, expected, atol=1e-9)


def test_loop_esc_stops(tetra_scene):
    arrays = tetra_scene.bake()
    events = [[("key_down", "w")], [("key_down", "esc")], [("key_down", "w")]]
    n = [0]

    def fake_render(scene, cam_arrays):
        n[0] += 1
        return np.zeros((2, 2, 3), dtype=np.float32)

    run_loop(arrays, tetra_scene.camera, fake_render, 32, 24, events=events)
    assert n[0] == 1  # stopped at esc


# ---- animation -------------------------------------------------------------

def test_orbit_camera_path_closes():
    cam = Camera.create([0, 0, 5], [0, 0, -1], 1.0)
    poses = animation.orbit_camera_path(cam, 8, radius=5.0)
    assert len(poses) == 8
    assert np.allclose(poses[0].pos, cam.pos)
    # All poses keep distance 5 from the center (origin).
    for p in poses:
        assert np.isclose(np.linalg.norm(p.pos), 5.0)
        # and look at the center
        assert np.allclose(p.forward, -p.pos / np.linalg.norm(p.pos), atol=1e-9)


def test_orbit_events_shape():
    evs = list(animation.orbit_events(320, 10, fov=1.0))
    assert evs[0][0] == ("key_down", "a")
    assert evs[-1] == [("key_up", "a")]


# ---- failure containment ----------------------------------------------------
#
# The reference's most-developed subsystem is failure detection: a failed or
# unassignable tile drops the whole frame and the stream continues
# (master/main.go:119-125,:153-161); a dead pool ends the run (pool.go:224-260).
# The loop must contain BOTH dispatch-time failures (render_fn raises before
# any device work is queued) and completion-time failures (the device array
# poisons np.asarray), count them as drops, and abort after a run of
# consecutive drops instead of spinning forever.

def test_loop_survives_dispatch_failure(tetra_scene):
    arrays = tetra_scene.bake()
    calls = []

    def flaky_render(scene, cam_arrays):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("injected dispatch failure")
        return np.zeros((4, 4, 3), dtype=np.float32)

    displayed = []
    events = [[("key_down", "w")], [], [], [("key_up", "w")]]
    cam, stats, dropped = run_loop(
        arrays, tetra_scene.camera, flaky_render, 32, 24,
        events=events, display=lambda i, img: displayed.append(i))
    assert len(calls) == 3          # loop kept issuing after the failure
    assert dropped == 1
    assert displayed == [1, 2]      # frame 0 dropped, stream continued
    assert stats.frames_drawn == 2


def test_loop_survives_completion_failure(tetra_scene):
    arrays = tetra_scene.bake()

    class Poisoned:
        def __array__(self, *a, **k):
            raise RuntimeError("injected device failure")

    count = [0]

    def flaky_render(scene, cam_arrays):
        count[0] += 1
        if count[0] == 2:
            return Poisoned()
        return np.zeros((4, 4, 3), dtype=np.float32)

    displayed = []
    events = [[("key_down", "w")], [], [], [], [("key_up", "w")]]
    cam, stats, dropped = run_loop(
        arrays, tetra_scene.camera, flaky_render, 32, 24,
        events=events, display=lambda i, img: displayed.append(i))
    assert dropped == 1
    assert displayed == [0, 2, 3]   # frame 1 dropped whole, in-order display
    assert stats.frames_drawn == 3


def test_loop_aborts_on_permanent_failure(tetra_scene):
    """A permanently failing device must end the loop, not spin forever."""
    import dataclasses

    from distributed_raytracer.utils.config import DEFAULT_CONFIG

    arrays = tetra_scene.bake()

    def dead_render(scene, cam_arrays):
        raise RuntimeError("device gone")

    cfg = dataclasses.replace(DEFAULT_CONFIG, max_consecutive_drops=5)
    # Endless input: without the abort this would run all 1000 ticks.
    events = ([[("key_down", "w")]] + [[]] * 999)
    cam, stats, dropped = run_loop(
        arrays, tetra_scene.camera, dead_render, 32, 24,
        events=events, cfg=cfg)
    assert dropped == 5             # stopped at the abort threshold


def test_loop_recovers_after_drop_run(tetra_scene):
    """Dispatch fails repeatedly, the recover hook rebuilds the render
    path, and the stream RESUMES — dropped-then-resumed frames, not an
    abort (worker/distributed/main.go:160-185's heal loop, at the process
    level). Stats record the successful recovery."""
    import dataclasses

    from distributed_raytracer.utils.config import DEFAULT_CONFIG

    arrays = tetra_scene.bake()

    def dead_render(scene, cam_arrays):
        raise RuntimeError("device gone")

    def good_render(scene, cam_arrays):
        return np.zeros((4, 4, 3), dtype=np.float32)

    attempts = []

    def recover(attempt):
        attempts.append(attempt)
        return good_render

    cfg = dataclasses.replace(DEFAULT_CONFIG, max_consecutive_drops=4)
    events = [[("key_down", "w")]] + [[]] * 19
    cam, stats, dropped = run_loop(
        arrays, tetra_scene.camera, dead_render, 32, 24,
        events=events, cfg=cfg, recover=recover)
    assert attempts == [1]          # one rebuild, called once
    assert dropped == 4             # the pre-recovery drop run
    assert stats.frames_drawn == 20 - 4
    assert stats.recoveries == 1


def test_loop_aborts_when_recovery_fails(tetra_scene):
    """Recovery that cannot heal (hook raises) must not loop forever."""
    import dataclasses

    from distributed_raytracer.utils.config import DEFAULT_CONFIG

    arrays = tetra_scene.bake()

    def dead_render(scene, cam_arrays):
        raise RuntimeError("device gone")

    def bad_recover(attempt):
        raise RuntimeError("rebuild also failed")

    cfg = dataclasses.replace(DEFAULT_CONFIG, max_consecutive_drops=3)
    events = [[("key_down", "w")]] + [[]] * 99
    cam, stats, dropped = run_loop(
        arrays, tetra_scene.camera, dead_render, 32, 24,
        events=events, cfg=cfg, recover=bad_recover)
    assert dropped == 3             # stopped at the first failed recovery


def test_loop_exhausts_recovery_budget(tetra_scene):
    """A render path that keeps dying consumes cfg.max_recoveries rebuilds
    and then aborts."""
    import dataclasses

    from distributed_raytracer.utils.config import DEFAULT_CONFIG

    arrays = tetra_scene.bake()

    def dead_render(scene, cam_arrays):
        raise RuntimeError("device gone")

    attempts = []

    def recover(attempt):
        attempts.append(attempt)
        return dead_render          # "healed" path dies again

    cfg = dataclasses.replace(DEFAULT_CONFIG, max_consecutive_drops=2,
                              max_recoveries=2)
    events = [[("key_down", "w")]] + [[]] * 99
    cam, stats, dropped = run_loop(
        arrays, tetra_scene.camera, dead_render, 32, 24,
        events=events, cfg=cfg, recover=recover)
    assert attempts == [1, 2]
    assert dropped == 6             # 3 drop runs of max_consecutive_drops=2
