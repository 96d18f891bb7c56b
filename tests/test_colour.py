"""Colour algebra semantics (shared/colour/colour.go)."""

import numpy as np
import jax.numpy as jnp

from distributed_raytracer.ops import colour


def test_sat_add_clamps_at_one():
    a = jnp.asarray([0.7, 0.2, 1.0])
    b = jnp.asarray([0.5, 0.3, 0.5])
    assert np.allclose(colour.sat_add(a, b), [1.0, 0.5, 1.0])


def test_sat_scale_clamps_both_ends():
    a = jnp.asarray([0.5, 0.5, 0.5])
    assert np.allclose(colour.sat_scale(a, 3.0), [1.0, 1.0, 1.0])
    assert np.allclose(colour.sat_scale(a, -1.0), [0.0, 0.0, 0.0])


def test_multiply_unclamped():
    a = jnp.asarray([0.5, 1.0, 0.0])
    b = jnp.asarray([0.5, 1.0, 0.9])
    assert np.allclose(colour.multiply(a, b), [0.25, 1.0, 0.0])


def test_to_u8_truncates():
    # uint8(255 * c) truncates: 0.999 -> 254 (colour.go:59-61)
    c = jnp.asarray([0.0, 0.999, 1.0, 0.5])
    assert colour.to_u8(c).tolist() == [0, 254, 255, 127]


def test_sequential_sat_add_equals_clamped_sum():
    """The identity the shading path relies on (ops/colour.py docstring)."""
    rng = np.random.default_rng(1)
    for _ in range(50):
        parts = rng.uniform(0, 0.8, size=(4, 3))
        seq = jnp.asarray(parts[0])
        for p in parts[1:]:
            seq = colour.sat_add(seq, jnp.asarray(p))
        assert np.allclose(seq, np.minimum(parts.sum(axis=0), 1.0), atol=1e-7)
