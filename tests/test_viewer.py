"""Browser viewer (runtime/viewer.py): HTTP surface + run_loop integration."""

import json
import urllib.request

import numpy as np

from distributed_raytracer.runtime import viewer as viewer_mod


def _get(url):
    with urllib.request.urlopen(url, timeout=5) as r:
        return r.status, r.read()


def test_viewer_http_surface():
    v = viewer_mod.ViewerServer(port=0)
    try:
        status, body = _get(v.url)
        assert status == 200 and b"/stream" in body

        # No frame yet.
        try:
            status, _ = _get(v.url + "frame.png")
            assert status == 404
        except urllib.error.HTTPError as e:
            assert e.code == 404

        img = np.zeros((24, 32, 3), np.float32)
        img[:, :, 0] = 1.0
        v.display(0, img)
        status, body = _get(v.url + "frame.png")
        assert status == 200 and body.startswith(b"\x89PNG")

        # Input round trip.
        req = urllib.request.Request(
            v.url + "input", method="POST",
            data=json.dumps({"kind": "key_down", "key": "w"}).encode())
        with urllib.request.urlopen(req, timeout=5) as r:
            assert r.status == 200
        req = urllib.request.Request(
            v.url + "input", method="POST",
            data=json.dumps({"kind": "mouse", "dx": 3, "dy": -2}).encode())
        with urllib.request.urlopen(req, timeout=5) as r:
            assert r.status == 200
        evs = v.drain_events()
        assert ("key_down", "w") in evs
        assert ("mouse", 3.0, -2.0) in evs

        status, body = _get(v.url + "stats")
        assert status == 200 and json.loads(body)["frames"] == 1
    finally:
        v.stop()


def test_viewer_drives_run_loop(tetra_scene):
    """Browser events -> controller -> frames -> viewer, ending on Esc."""
    from distributed_raytracer.runtime.loop import run_loop

    v = viewer_mod.ViewerServer(port=0)
    calls = []

    def render_fn(scene_arrays, cam_arrays):
        calls.append(cam_arrays)
        return np.zeros((12, 16, 3), np.float32)

    # Events arrive over time, as from a browser: w held for a moment
    # (dirty ticks -> frames), then Esc ends the loop.
    import threading
    import time

    v.push_event({"kind": "key_down", "key": "w"})

    def later():
        time.sleep(0.2)
        v.push_event({"kind": "key_up", "key": "w"})
        v.push_event({"kind": "key_down", "key": "esc"})

    t = threading.Thread(target=later)
    t.start()
    try:
        cam, stats, dropped = run_loop(
            tetra_scene.bake(), tetra_scene.camera, render_fn, 16, 12,
            events=v.events(), display=v.display, realtime=True)
        t.join()
        # w held across >= 1 tick -> >= 1 frame; Esc ended the loop.
        assert len(calls) >= 1
        assert v.stats_dict()["frames"] == len(calls)
        assert dropped == 0
        # The camera moved forward (reference move semantics).
        assert not np.allclose(np.asarray(cam.pos),
                               np.asarray(tetra_scene.camera.pos))
    finally:
        v.stop()


def test_viewer_serve_until_esc(tetra_scene):
    """The blocking serve() helper ends when a client sends Esc."""
    import threading
    import time

    def render_fn(scene_arrays, cam_arrays):
        return np.zeros((12, 16, 3), np.float32)

    holder = {}

    def on_ready(v):
        holder["v"] = v

        def quit_later():
            time.sleep(0.2)
            v.push_event({"kind": "key_down", "key": "esc"})

        threading.Thread(target=quit_later, daemon=True).start()

    cam, stats, dropped = viewer_mod.serve(
        None, tetra_scene.camera, render_fn, 16, 12, port=0,
        on_ready=on_ready)
    assert dropped == 0
