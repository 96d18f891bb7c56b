"""Multi-chip SPMD rendering over a jax.sharding.Mesh.

The SPMD replacement for the reference's master/worker tile dispatch
(master/main.go:94-187 coordinator + master/pool/pool.go least-loaded heap +
gRPC BulkTrace): the ray grid is statically row-partitioned across the device
mesh with shard_map; scene geometry is replicated to every device (the analog
of registrar.go:41-47 shipping the full scene to every worker); each device
generates and traces only its own rays; the sharded framebuffer is gathered
to the host for display. No collectives are needed in the forward render —
rays are embarrassingly parallel — so scaling is limited only by the final
device->host gather.

Capability mapping (see SURVEY.md §2): heartbeats, elastic membership, and
tile redundancy have no SPMD equivalent — an SPMD program gang-schedules
its devices and fails as a unit. Those roles move to the runtime layer (restartable frame
loop, checkpoint-free re-dispatch), a deliberate divergence documented here.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

try:  # jax >= 0.4.35 exposes shard_map at top level
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

from distributed_raytracer.models.camera import CameraArrays
from distributed_raytracer.models.scene import SceneArrays
from distributed_raytracer.ops import raygen
from distributed_raytracer.ops.render import trace_rays
from distributed_raytracer.parallel.tile import row_partition
from distributed_raytracer.utils.config import RenderConfig, DEFAULT_CONFIG


def default_mesh(n_devices: Optional[int] = None) -> Mesh:
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return jax.make_mesh((len(devices),), ("tiles",), devices=devices)


def make_sharded_renderer(width: int, height: int, mesh: Optional[Mesh] = None,
                          cfg: RenderConfig = DEFAULT_CONFIG):
    """Build a jitted (scene, cam) -> (H, W, 3) renderer sharded over `mesh`.

    Each device owns a contiguous block of flat pixel indices (row-major), so
    the output sharding is a clean row partition of the framebuffer.
    """
    if mesh is None:
        mesh = default_mesh()
    n_shards = mesh.devices.size
    n_rays = width * height
    chunk = min(cfg.ray_chunk, -(-n_rays // n_shards))
    per_shard = row_partition(n_rays, n_shards, chunk)

    def shard_fn(scene: SceneArrays, cam: CameraArrays):
        shard = jax.lax.axis_index("tiles")
        base = (shard * per_shard).astype(jnp.int32)
        idx = base + jnp.arange(per_shard, dtype=jnp.int32)
        dirs = raygen.ray_directions_flat(cam, width, height, idx)

        def chunk_fn(d):
            return trace_rays(scene, cam.pos, cam.pos, d, cfg)

        colours = jax.lax.map(chunk_fn, dirs.reshape(-1, chunk, 3))
        return colours.reshape(per_shard, 3)

    sharded = shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P()),    # scene + camera replicated on every device
        out_specs=P("tiles"),   # framebuffer row-partitioned
    )

    render_padded = jax.jit(sharded)  # (n_shards * per_shard, 3), row-sharded

    def render(scene: SceneArrays, cam: CameraArrays) -> np.ndarray:
        """Full frame as a host numpy array (the framebuffer-gather step —
        the analog of the master reassembling worker tiles, main.go:163-177).
        """
        flat = np.asarray(render_padded(scene, cam))
        return flat[:n_rays].reshape(height, width, 3)

    render.device_fn = render_padded  # padded, still-sharded output for perf paths
    return render


@functools.lru_cache(maxsize=8)
def _cached_renderer(width: int, height: int, n_devices: Optional[int],
                     cfg: RenderConfig):
    return make_sharded_renderer(width, height, default_mesh(n_devices), cfg)


def render_frame_sharded(scene: SceneArrays, cam: CameraArrays, width: int,
                         height: int, n_devices: Optional[int] = None,
                         cfg: RenderConfig = DEFAULT_CONFIG) -> jnp.ndarray:
    """Convenience wrapper with renderer caching keyed on (W, H, devices)."""
    return _cached_renderer(width, height, n_devices, cfg)(scene, cam)
