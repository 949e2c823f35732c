"""Matrix-product precision for geometry.

A float32 product left at DEFAULT precision may run in TF32 (about ten
mantissa bits) on a GPU.  The engine gathers camera poses with one-hot
products and projects points through rotation matrices, so a TF32 product
would shift a 30 m translation by ~15 mm — several pixels at the intrinsics
bundle adjustment fits to half a pixel.  Every product that carries geometry
therefore asks for full float32 precision through these helpers.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

HIGHEST = jax.lax.Precision.HIGHEST


def mm(a, b):
    """`a @ b` at full float32 precision."""
    return jnp.matmul(a, b, precision=HIGHEST)


def einsum(subscripts, *operands, **kwargs):
    """`jnp.einsum` at full float32 precision."""
    return jnp.einsum(subscripts, *operands, precision=HIGHEST, **kwargs)
