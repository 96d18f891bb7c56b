"""Profiling and work accounting.

The reference's only instrumentation is exit-time FPS statistics
(master/main.go:285-325, reproduced in runtime/stats.py). This module adds
  - jax.profiler trace capture around frames,
  - per-frame work accounting for the block-sparse path: (ray, triangle)
    pairs scheduled by the cull, and their share of the device's
    arithmetic peak.

Roofline: one Baldwin–Weber pair evaluation is ~PAIR_FLOPS f32 operations
(den/u/v direction dots, the division, the barycentric fmas, seven
compares, the masked min fold). They run on the GPU's f32 CUDA cores — no
matrix unit takes them at f32 accuracy — so the ceiling is the device's
published f32 non-tensor peak, looked up by `device_kind`. A device missing
from the table gets no fraction, never a default.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional

PAIR_FLOPS = 47.0
# Published dense f32 (non-tensor-core) peaks in FLOP/s, keyed by JAX's
# device_kind (NVIDIA H100 data sheet; SXM at its 700 W limit).
F32_PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": 67e12,
}


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace over the enclosed block (view with TensorBoard)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@dataclasses.dataclass
class FrameWork:
    """Work accounting for one block-sparse frame."""

    primary_cells: int
    shadow_cells: int
    rays: int
    ray_tile: int
    tri_block: int
    seconds: float
    device_kind: str

    @property
    def pairs(self) -> float:
        return (self.primary_cells + self.shadow_cells) * self.ray_tile * self.tri_block

    @property
    def gpairs_per_sec(self) -> float:
        return self.pairs / self.seconds / 1e9

    @property
    def gflops(self) -> float:
        return self.pairs * PAIR_FLOPS / 1e9

    @property
    def peak_fraction(self) -> Optional[float]:
        """Scheduled (post-cull, pre-skip) pair FLOP/s over the device's
        f32 peak; None for a device not in F32_PEAK_FLOPS. Frame time
        includes cull + compaction + shading, so this is an end-to-end
        fraction; the traversal-only fraction is higher."""
        peak = F32_PEAK_FLOPS.get(self.device_kind)
        if peak is None:
            return None
        return self.pairs * PAIR_FLOPS / self.seconds / peak

    def report(self) -> str:
        frac = self.peak_fraction
        share = ("no peak on record" if frac is None
                 else f"{frac:.1%} of the f32 peak")
        return (f"{self.rays} rays, {self.primary_cells}+{self.shadow_cells} "
                f"work cells ({self.pairs / 1e9:.2f} G pairs scheduled) in "
                f"{self.seconds * 1e3:.1f} ms -> {self.gpairs_per_sec:.1f} "
                f"Gpairs/s ({share}, {self.device_kind})")


def measure_culled(renderer, camera, frames: int = 10) -> FrameWork:
    """Time the frozen fast path of a CulledRenderer and account its work."""
    import jax

    renderer.render(camera, block=True)
    renderer.freeze(camera)
    out = renderer.render_fast(camera)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(frames):
        out = renderer.render_fast(camera)
    jax.block_until_ready(out)
    seconds = (time.perf_counter() - t0) / frames
    lc = renderer._last_counts
    count = lc[renderer.n_levels - 1]   # finest primary cells
    scount = lc[-1]                     # finest shadow cells
    return FrameWork(
        primary_cells=int(count),
        shadow_cells=int(scount),
        rays=renderer.width * renderer.height,
        ray_tile=renderer.rt,
        tri_block=renderer.tb,
        seconds=seconds,
        device_kind=jax.devices()[0].device_kind,
    )
