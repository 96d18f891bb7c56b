"""Recovery against a REAL dead device client (not an injected exception).

The reference heals from worker death by re-registration: the master evicts
the dead worker on heartbeat loss and a (re)joining worker receives the full
scene again (pool.go:224-260, worker/distributed/main.go:160-185). The SPMD
analog in runtime/loop.py tears down and rebuilds the render path via its
`recover` hook — but until round 4 that path had only ever been exercised
with exceptions raised from a fake render_fn. This harness kills an actual
render CLIENT PROCESS mid-stream:

  - a CHILD process owns the device client (GPU or CPU) and serves rendered
    frames over a pipe (the worker);
  - the parent's render_fn proxies to it (the master's BulkTrace call);
  - at a scripted frame the parent SIGKILLs the child (the GCE
    delete-instance fault injection of final_report.pdf §3.1/3.4);
  - dead-pipe renders raise, drops accumulate, and the loop's recover hook
    spawns a FRESH child — a new process, new device client, full scene
    reload: exactly the re-registration semantics;
  - every frame displayed after recovery must equal the healthy-run frame
    for the same pose.

Run directly for the on-hardware smoke step (the GPU client is the thing
being killed; the parent stays off the device):
    python -u tools/loop_recovery_smoke.py
The CPU-backend variant runs in CI as tests/test_recovery_child.py.
"""

from __future__ import annotations

import dataclasses
import os
import struct
import subprocess
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

import numpy as np  # noqa: E402

_FRAME_FLOATS = 13   # pos(3) forward(3) left(3) up(3) fov(1)


def child_main(w: int, h: int) -> int:
    """Serve culled frames over stdin/stdout (length-prefixed u8 RGB)."""
    import jax

    # Tests force the CPU backend in the child (jax.config wins over the
    # env var — tests/conftest.py).
    plat = os.environ.get("DRT_CHILD_PLATFORM")
    if plat:
        jax.config.update("jax_platforms", plat)

    from distributed_raytracer.models.camera import CameraArrays
    from distributed_raytracer.ops.render_bvh import CulledRenderer
    from distributed_raytracer.runtime import framebuffer
    from distributed_raytracer.utils.jaxtools import (
        enable_compilation_cache)
    from __graft_entry__ import _example_scene

    enable_compilation_cache()
    scene = _example_scene()
    r = CulledRenderer(scene, w, h)
    r.render(scene.camera, block=True)
    r.freeze(scene.camera)
    out = sys.stdout.buffer
    out.write(b"READY\n")
    out.flush()
    inp = sys.stdin.buffer
    while True:
        raw = inp.read(8 * _FRAME_FLOATS)
        if len(raw) < 8 * _FRAME_FLOATS:
            return 0                       # parent closed the pipe
        v = np.frombuffer(raw, np.float64)
        cam = CameraArrays(pos=v[0:3].astype(np.float32),
                           forward=v[3:6].astype(np.float32),
                           left=v[6:9].astype(np.float32),
                           up=v[9:12].astype(np.float32),
                           fov=np.float32(v[12]))
        img = np.asarray(framebuffer.to_u8(np.asarray(r.render_fast(cam))))
        data = img.tobytes()
        out.write(struct.pack("<I", len(data)))
        out.write(data)
        out.flush()


class ChildRenderer:
    """The master-side proxy: one render client living in a child process.

    render() raises on a dead/closed child — the loop counts that as a
    dropped frame, exactly like a failed BulkTrace (pool.go:169-175)."""

    def __init__(self, w: int, h: int, env: dict | None = None,
                 ready_timeout: float = 600.0):
        self.w, self.h = w, h
        cmd = [sys.executable, "-u", os.path.abspath(__file__),
               "--child", str(w), str(h)]
        self.proc = subprocess.Popen(
            cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            cwd=_REPO, env=dict(os.environ, **(env or {})))
        line = self.proc.stdout.readline()
        t0 = time.monotonic()
        while line.strip() != b"READY":
            if not line or time.monotonic() - t0 > ready_timeout:
                raise RuntimeError(f"child did not become ready: {line!r}")
            line = self.proc.stdout.readline()

    def render(self, cam) -> np.ndarray:
        v = np.concatenate([np.asarray(cam.pos, np.float64),
                            np.asarray(cam.forward, np.float64),
                            np.asarray(cam.left, np.float64),
                            np.asarray(cam.up, np.float64),
                            [float(cam.fov)]])
        try:
            self.proc.stdin.write(v.tobytes())
            self.proc.stdin.flush()
            hdr = self.proc.stdout.read(4)
            if len(hdr) < 4:
                raise IOError("child pipe closed")
            (n,) = struct.unpack("<I", hdr)
            data = self.proc.stdout.read(n)
            if len(data) < n:
                raise IOError("short frame from child")
        except Exception as e:
            raise RuntimeError(f"render client dead: {e}") from e
        return np.frombuffer(data, np.uint8).reshape(self.h, self.w, 3)

    def kill(self):
        self.proc.kill()

    def close(self):
        try:
            self.proc.stdin.close()
            self.proc.wait(timeout=10)
        except Exception:
            self.proc.kill()


def run_smoke(w: int = 160, h: int = 120, n_ticks: int = 24,
              kill_at: int = 6, env: dict | None = None, log=print):
    """Golden pass (healthy child) then a faulted pass (child SIGKILLed at
    displayed frame `kill_at`, recovery spawns a fresh child). Returns
    (ok: bool, detail: str)."""
    from distributed_raytracer.runtime import animation
    from distributed_raytracer.runtime.loop import run_loop
    from distributed_raytracer.utils.config import DEFAULT_CONFIG
    from __graft_entry__ import _example_scene

    scene = _example_scene()
    events = lambda: list(animation.orbit_events(w, n_ticks,
                                                 fov=scene.camera.fov))
    cfg = dataclasses.replace(DEFAULT_CONFIG, max_consecutive_drops=3,
                              frames_in_flight=1)

    # Pass 1: healthy run -> golden frames per index.
    child = ChildRenderer(w, h, env=env)
    golden = {}
    _, stats_ok, dropped_ok = run_loop(
        None, scene.camera, lambda s, c: child.render(c), w, h,
        events=events(),
        display=lambda idx, img: golden.__setitem__(idx, img.copy()),
        cfg=cfg)
    child.close()
    if dropped_ok:
        return False, f"healthy pass dropped {dropped_ok} frames"
    log(f"  healthy pass: {stats_ok.frames_total} frames")

    # Pass 2: kill the client mid-stream; the recover hook re-registers.
    state = {"child": ChildRenderer(w, h, env=env), "spawned": 1}
    shown = {}

    def display(idx, img):
        shown[idx] = img.copy()
        if idx == kill_at:
            log(f"  killing render client at frame {idx}")
            state["child"].kill()

    def recover(attempt):
        log(f"  recover attempt {attempt}: spawning fresh client")
        state["child"].kill()
        state["child"] = ChildRenderer(w, h, env=env)
        state["spawned"] += 1
        return lambda s, c: state["child"].render(c)

    _, stats, dropped = run_loop(
        None, scene.camera, lambda s, c: state["child"].render(c), w, h,
        events=events(), display=display, cfg=cfg, recover=recover)
    state["child"].close()

    if stats.recoveries != 1:
        return False, f"expected 1 recovery, got {stats.recoveries}"
    if state["spawned"] != 2:
        return False, f"expected 2 client processes, got {state['spawned']}"
    resumed = [i for i in shown if i > kill_at]
    if not resumed:
        return False, "no frames displayed after the kill"
    for i in resumed:
        if i in golden and not np.array_equal(shown[i], golden[i]):
            return False, f"post-recovery frame {i} != healthy frame"
    checked = len([i for i in resumed if i in golden])
    return True, (f"{stats.frames_total} issued, {dropped} dropped, "
                  f"1 recovery, {checked} post-recovery frames verified "
                  f"against the healthy run")


def main() -> int:
    t0 = time.monotonic()
    ok, detail = run_smoke()
    wall = time.monotonic() - t0
    print(f"loop_recovery_smoke: {'PASSED' if ok else 'FAILED'} in "
          f"{wall:.0f}s — {detail}")
    return 0 if ok else 1


if __name__ == "__main__":
    if len(sys.argv) >= 4 and sys.argv[1] == "--child":
        sys.exit(child_main(int(sys.argv[2]), int(sys.argv[3])))
    sys.exit(main())
