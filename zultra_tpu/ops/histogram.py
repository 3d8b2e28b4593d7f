"""Symbol histograms on the device.

Per-block symbol-frequency histograms feed the Huffman layer; corpus-level
histograms are psum'd across the device mesh (see zultra_tpu.parallel).
``token_histogram_jax`` counts in int32, so every count is exact.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("n_symbols",))
def token_histogram_jax(symbols: jnp.ndarray, n_symbols: int = 288) -> jnp.ndarray:
    """Histogram of int32 symbols in [0, n_symbols): an int32 one-hot sum."""
    one_hot = jax.nn.one_hot(symbols, n_symbols, dtype=jnp.int32)
    return jnp.sum(one_hot, axis=0)
