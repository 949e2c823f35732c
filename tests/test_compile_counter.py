"""protocols.CompileCounter counts XLA compiles only while it is open."""

import os
import sys

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from protocols import CompileCounter  # noqa: E402


def test_counts_new_compiles_only_inside_the_context():
    f = jax.jit(lambda x: x * 3.0 + 1.0)
    x3, x5, x7 = (jnp.ones(n) for n in (3, 5, 7))
    with CompileCounter() as cc:
        f(x3).block_until_ready()
        f(x3).block_until_ready()  # cached: no new compile
        f(x5).block_until_ready()  # new shape: compiles
    assert cc.compiles == 2
    f(x7).block_until_ready()  # after exit: not counted
    assert cc.compiles == 2
