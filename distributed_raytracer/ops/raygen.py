"""Primary-ray generation (pinhole projection).

Reproduces tracer.go:15-22 `pixelToPoint` exactly, including its integer
half-width/height division and 0.5 pixel-center offset:

  halfW, halfH = W // 2, H // 2            (integer division)
  projHalfWidth  = tan(fov / 2)
  projHalfHeight = projHalfWidth * H / W
  iOffset = left * projHalfWidth  * ((halfW - i) - 0.5) / halfW
  jOffset = up   * projHalfHeight * ((halfH - j) - 0.5) / halfH
  point   = pos + forward + iOffset + jOffset   (plane at distance 1)

and the primary ray direction is norm(point - pos) (tracer.go:83-86).
Note the reference's screen-left maps to the camera's `left` vector — i
increases toward -left. The image array is returned row-major [H, W, 3] with
row j (top row j=0) and column i.
"""

from __future__ import annotations

import jax.numpy as jnp

from distributed_raytracer.models.camera import CameraArrays


def ray_directions(cam: CameraArrays, width: int, height: int) -> jnp.ndarray:
    """Normalized primary ray directions, shape (height, width, 3).

    Delegates to ray_directions_flat so the dense and block-sparse render
    paths see bit-identical directions (different fp evaluation orders flip
    edge-pixel hit decisions)."""
    idx = jnp.arange(width * height, dtype=jnp.int32)
    return ray_directions_flat(cam, width, height, idx).reshape(height, width, 3)


def ray_directions_flat(cam: CameraArrays, width: int, height: int,
                        idx: jnp.ndarray) -> jnp.ndarray:
    """Directions for flat pixel indices idx (row-major j*width + i).

    Used by the sharded renderer: each device generates rays only for its own
    contiguous index block (the static analog of the master handing each
    worker a WorkOrder rectangle). Indices past the last pixel are clamped —
    padding rays are traced and discarded by the caller.
    """
    idx = jnp.minimum(idx, width * height - 1)
    i = (idx % width).astype(jnp.float32)
    j = (idx // width).astype(jnp.float32)

    half_w, half_h = width // 2, height // 2
    phw = jnp.tan(cam.fov / 2.0)
    phh = phw * (height / width)
    a = phw * ((half_w - i) - 0.5) / half_w
    b = phh * ((half_h - j) - 0.5) / half_h

    d = (cam.forward[None, :] + a[:, None] * cam.left[None, :]
         + b[:, None] * cam.up[None, :])
    return d / jnp.linalg.norm(d, axis=-1, keepdims=True)


def ray_rows_flat(cam: CameraArrays, width: int, height: int,
                  idx: jnp.ndarray) -> jnp.ndarray:
    """Directions as (3, R) rows — the block-sparse path's native layout.

    (R, 3) arrays invite strided access and layout copies; rows keep each
    coordinate a dense (R,) vector. Values are bit-identical to ray_directions_flat (same
    multiplies, same add order, elementwise-commuted broadcasts only).
    """
    idx = jnp.minimum(idx, width * height - 1)
    i = (idx % width).astype(jnp.float32)
    j = (idx // width).astype(jnp.float32)

    half_w, half_h = width // 2, height // 2
    phw = jnp.tan(cam.fov / 2.0)
    phh = phw * (height / width)
    a = phw * ((half_w - i) - 0.5) / half_w
    b = phh * ((half_h - j) - 0.5) / half_h

    d = (cam.forward[:, None] + a[None, :] * cam.left[:, None]
         + b[None, :] * cam.up[:, None])
    return d / jnp.linalg.norm(d, axis=0, keepdims=True)
