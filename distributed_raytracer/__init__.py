"""distributed_raytracer — a JAX-native distributed raytracer.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
MWindels/distributed-raytracer (a Go master/worker Whitted-style raytracer):
OBJ/MTL scene loading, Möller–Trumbore ray-triangle intersection, hard
shadows, Phong shading, screen partitioning across workers, an interactive
frame loop with FPS statistics, and elastic distributed execution — rebuilt
as array programs over a `jax.sharding.Mesh` with a Pallas kernel on the
hot path.

Layer map (mirrors SURVEY.md §1):
  models/    scene model: camera, lights, materials, meshes, environments, BVH
  ops/       compute kernels: ray gen, intersection, shading, colour algebra
  parallel/  device-mesh sharding: tile partition, sharded render, multi-host
  runtime/   frame loop, camera controller, stats, framebuffer output
  utils/     config, oracle (golden NumPy tracer), profiling
"""

__version__ = "0.1.0"

from distributed_raytracer.models.camera import Camera
from distributed_raytracer.models.scene import Scene, load_scene
from distributed_raytracer.ops.render import render_frame
