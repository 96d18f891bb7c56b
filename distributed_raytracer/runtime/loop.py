"""Interactive frame loop with pipelined dispatch.

The array-program analog of the master's 30 Hz input loop + per-frame
coordinator goroutines (master/main.go:240-280, :94-187). The reference
pipelines frames by spawning one coordinator per frame and forcing in-order
display with a channel chain; here, JAX's asynchronous dispatch is the
pipeline: each frame's device computation is enqueued without blocking, a
bounded deque of in-flight frames (cfg.frames_in_flight) provides
backpressure, and FIFO completion guarantees in-order display. Input events
come from a pluggable source (scripted animation when headless); the display
sink is a callback.

Fault-handling mapping: the reference drops whole frames when a tile fails
(main.go:119-125,:153-161) and relies on worker heartbeats/re-registration. An
SPMD device program fails as a unit, so per-tile recovery does not apply; the
loop instead treats a failed device step as a dropped frame and continues
(drop accounting preserved so the §3 drop-rate metric remains reportable).

Recovery (not just containment): the reference HEALS — a failed or
partitioned worker idles out, shuts its server, and re-enters the
registration loop (worker/distributed/main.go:160-185) while the master
evicts it on heartbeat loss (pool.go:224-260), so the system returns to
full service without operator action. The SPMD analog lives at the process
level: when a run of consecutive drops says the renderer (or its device
client) is wedged, the loop calls the pluggable `recover` hook to tear
down and rebuild the render path, then resumes the frame stream; it
aborts only when recovery itself fails or the rebuilt path keeps failing
(cfg.max_recoveries). `make_culled_recoverer` is the stock rebuild hook
for the production block-sparse path.
"""

from __future__ import annotations

import collections
import logging
import time
from typing import Callable, Iterable, Optional

_log = logging.getLogger(__name__)

import jax
import numpy as np

from distributed_raytracer.models.camera import Camera
from distributed_raytracer.models.scene import SceneArrays
from distributed_raytracer.runtime.controller import CameraController
from distributed_raytracer.runtime.stats import FrameTimer, FrameStats
from distributed_raytracer.utils.config import RenderConfig, DEFAULT_CONFIG


def run_loop(
    scene_arrays: SceneArrays,
    camera: Camera,
    render_fn: Callable,            # (scene, cam_arrays) -> device array (H, W, 3)
    width: int,
    height: int,
    events: Iterable,               # iterable of per-tick event lists
    display: Optional[Callable] = None,   # (frame_index, np image) -> None
    cfg: RenderConfig = DEFAULT_CONFIG,
    realtime: bool = False,         # pace ticks at cfg.target_fps (main.go:271-275)
    max_frames: Optional[int] = None,
    recover: Optional[Callable] = None,   # (attempt) -> new render_fn
):
    """Drive the interactive loop until events are exhausted or Esc.

    Each element of `events` is a list of (kind, *args) tuples with kinds
    "key_down"/"key_up"/"mouse" — the HandleInputs analog. Returns
    (final_camera, FrameStats).

    `recover`, when given, is called with the 1-based attempt number after
    cfg.max_consecutive_drops consecutive dropped frames; it should tear
    down and rebuild the render path (fresh renderer, fresh device client)
    and return the replacement render_fn — the worker re-registration
    analog (worker/distributed/main.go:160-185). Returning None or raising
    means recovery failed; the loop aborts after cfg.max_recoveries
    failed-or-exhausted attempts. Successful recoveries are counted in
    FrameStats.recoveries.
    """
    controller = CameraController(width=width, height=height, cfg=cfg)
    timer = FrameTimer()
    in_flight = collections.deque()  # (frame_index, device_array)
    frames_dropped = 0
    consecutive_drops = 0
    recoveries = 0
    ms_per_frame = 1000.0 / cfg.target_fps

    def try_recover():
        """Rebuild the render path via the `recover` hook. Returns True if
        the stream should continue (with render_fn replaced)."""
        nonlocal render_fn, consecutive_drops, recoveries, frames_dropped
        if recover is None or recoveries >= cfg.max_recoveries:
            return False
        # In-flight results belong to the torn-down path. ABANDON them as
        # drops without synchronizing: draining would block on np.asarray,
        # and a client that HANGS (rather than raises) would turn the heal
        # path into a deadlock — the exact wedge recovery exists for.
        # Display order is preserved (nothing later has been shown).
        while in_flight:
            idx, _ = in_flight.popleft()
            frames_dropped += 1
            _log.warning("frame %d abandoned (recovery)", idx)
        attempt = recoveries + 1
        try:
            new_fn = recover(attempt)
        except Exception:
            _log.exception("recovery attempt %d failed", attempt)
            return False
        if new_fn is None:
            return False
        _log.warning("recovered render path (attempt %d); resuming stream",
                     attempt)
        render_fn = new_fn
        recoveries = attempt
        consecutive_drops = 0
        return True

    def drain_one():
        nonlocal frames_dropped, consecutive_drops
        idx, fut = in_flight.popleft()
        try:
            img = np.asarray(fut)  # blocks until the device finishes
        except Exception:          # device failure -> dropped frame
            frames_dropped += 1
            consecutive_drops += 1
            _log.warning("frame %d dropped (device failure)", idx)
            return
        consecutive_drops = 0
        timer.frame_drawn()
        if display is not None:
            display(idx, img)

    for tick_events in events:
        tick_start = time.monotonic()
        for ev in tick_events:
            kind = ev[0]
            if kind == "key_down":
                controller.key_down(ev[1])
            elif kind == "key_up":
                controller.key_up(ev[1])
            elif kind == "mouse":
                controller.mouse_motion(ev[1], ev[2])
        if not controller.running:
            break

        if controller.dirty:  # frames only on input change (main.go:246)
            camera = controller.apply(camera)
            frame_index = timer.frames_total
            timer.frame_issued()
            try:
                # Dispatch-time protection: render_fn may raise before any
                # device work is enqueued (bad buckets, host-side sizing,
                # compile errors) — contain it like a failed tile
                # (main.go:119-125), do not let it escape the loop.
                fut = render_fn(scene_arrays, camera.to_arrays())
            except Exception:
                frames_dropped += 1
                consecutive_drops += 1
                _log.warning("frame %d dropped (dispatch failure)",
                             frame_index)
            else:
                # Start the device->host copy immediately (non-blocking):
                # frame k's transfer overlaps frame k+1's compute.
                copy_async = getattr(fut, "copy_to_host_async", None)
                if copy_async is not None:
                    try:
                        copy_async()
                    except Exception:
                        pass   # the drain's np.asarray still works
                in_flight.append((frame_index, fut))
                while len(in_flight) > cfg.frames_in_flight:
                    drain_one()
            if consecutive_drops >= cfg.max_consecutive_drops:
                # The render path looks wedged: heal it if we can
                # (re-registration analog); abort only when recovery is
                # unavailable, exhausted, or itself failing — otherwise
                # the loop would spin at target FPS with every frame a
                # drop.
                if not try_recover():
                    _log.error("aborting after %d consecutive dropped "
                               "frames", consecutive_drops)
                    break
            if max_frames is not None and timer.frames_total >= max_frames:
                break

        if realtime:
            elapsed_ms = (time.monotonic() - tick_start) * 1000.0
            if elapsed_ms < ms_per_frame:
                time.sleep((ms_per_frame - elapsed_ms) / 1000.0)

    while in_flight:
        drain_one()
    stats = timer.stats()
    if stats is not None:
        stats.recoveries = recoveries
    return camera, stats, frames_dropped


def make_culled_recoverer(scene, width: int, height: int, **renderer_kwargs):
    """Stock `recover` hook for the block-sparse path: builds a FRESH
    CulledRenderer (new bake upload, new compiled pipeline, new executables
    — everything the old wedged path owned) and returns a render_fn over
    it. Clears jax's live caches first so poisoned executables are not
    reused. The reference analog: a worker that idled out rebuilds its
    server and re-registers from scratch, receiving the full scene again
    (worker/distributed/main.go:101-129,:160-171)."""
    def recover(attempt: int):
        import jax

        from distributed_raytracer.ops.render_bvh import CulledRenderer

        jax.clear_caches()
        r = CulledRenderer(scene, width, height, **renderer_kwargs)
        r.render(scene.camera, block=True)
        r.freeze(scene.camera)
        return lambda scene_arrays, cam_arrays: r.render_fast(cam_arrays)
    return recover
