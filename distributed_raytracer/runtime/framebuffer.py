"""Framebuffer output: uint8 conversion and PPM/PNG writers.

The reference displays via an SDL2 window (shared/screen/screen.go);
headless accelerator hosts get image-file output instead (the
capability-mapping decision in SURVEY.md §7.7). PNG encoding is hand-rolled over stdlib zlib to avoid
imaging dependencies.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def to_u8(img) -> np.ndarray:
    """Float [0,1] (H, W, 3) -> uint8, truncating like colour.go:59-61."""
    arr = np.asarray(img)
    return (255.0 * np.clip(arr, 0.0, 1.0)).astype(np.uint8)


def to_u8_device(img):
    """to_u8 ON DEVICE (jitted): the display loop converts before the
    device->host transfer, so the wire carries 1 byte/channel instead of a
    float32 — the same truncating conversion the display needs anyway
    (colour.go:59-61). 4x less host-link traffic per displayed frame."""
    import jax

    global _to_u8_jit
    if _to_u8_jit is None:
        import jax.numpy as jnp

        _to_u8_jit = jax.jit(
            lambda x: (255.0 * jnp.clip(x, 0.0, 1.0)).astype(jnp.uint8))
    return _to_u8_jit(img)


_to_u8_jit = None


def write_ppm(path: str, img) -> None:
    """Binary PPM (P6)."""
    u8 = to_u8(img) if np.asarray(img).dtype != np.uint8 else np.asarray(img)
    h, w, _ = u8.shape
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(u8.tobytes())


def png_bytes(img, level: int = 6) -> bytes:
    """Minimal RGB8 PNG encoder (stdlib zlib only)."""
    u8 = to_u8(img) if np.asarray(img).dtype != np.uint8 else np.asarray(img)
    h, w, _ = u8.shape
    # Filter byte 0 (None) per scanline.
    raw = b"".join(b"\x00" + u8[row].tobytes() for row in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, level)) + chunk(b"IEND", b""))


def write_png(path: str, img) -> None:
    with open(path, "wb") as f:
        f.write(png_bytes(img))


def read_png(path: str) -> np.ndarray:
    """Read back a PNG written by write_png (8-bit RGB, filter 0 scanlines)
    — for round-trip tests; not a general PNG decoder."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG"
    pos, w = 8, None
    idat = b""
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", body[:10])
            assert (depth, ctype) == (8, 2), "only 8-bit RGB supported"
        elif tag == b"IDAT":
            idat += body
        pos += 12 + length
    raw = zlib.decompress(idat)
    stride = 1 + 3 * w
    rows = []
    for r in range(h):
        line = raw[r * stride:(r + 1) * stride]
        assert line[0] == 0, "only filter 0 supported"
        rows.append(np.frombuffer(line[1:], dtype=np.uint8))
    return np.stack(rows).reshape(h, w, 3)


def read_ppm(path: str) -> np.ndarray:
    """Read back a P6 PPM (for round-trip tests)."""
    with open(path, "rb") as f:
        assert f.readline().strip() == b"P6"
        line = f.readline()
        while line.startswith(b"#"):
            line = f.readline()
        w, h = map(int, line.split())
        assert f.readline().strip() == b"255"
        data = np.frombuffer(f.read(w * h * 3), dtype=np.uint8)
    return data.reshape(h, w, 3)
