"""Closed-form DEFLATE symbol mappings — elementwise bit arithmetic
instead of table gathers.

The (encoded length → symbol/extra/base) and (offset index →
symbol/extra/base) maps (constants._build_length_tables /
_build_offset_tables, mirroring reference src/blockdeflate.c:42-85) are
pure functions of floor(log2(·)) and one mantissa bit, so the hot device
paths compute them in ~10 fusible elementwise ops instead of gathering
from the 256/512-entry tables — the planner pays several (n, 8)-shaped
lookups per convergence pass.

Exactness: asserted equal to the generated tables for EVERY index in
tests/test_ops.py (and the out-of-range guard indices 510/511 are only
reachable under masks every caller applies).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax


def floor_log2(x):
    """floor(log2(x)) for int32 x ≥ 1 (callers clamp), via bit smear +
    popcount — no gather, no float conversion."""
    x = x | (x >> 1)
    x = x | (x >> 2)
    x = x | (x >> 4)
    x = x | (x >> 8)
    return lax.population_count(x) - 1


def matchlen_sym_extra_base(e):
    """(symbol, extra_bits, encoded_base) for encoded length e = len - 3,
    0..255 — equals MATCHLEN_SYMBOL/EXTRA_BITS/BASE[e] elementwise."""
    e = e.astype(jnp.int32)
    k = jnp.maximum(floor_log2(jnp.maximum(e, 1)), 2)
    extra_hi = k - 2
    q = e >> extra_hi
    sym_hi = 249 + 4 * k + q
    base_hi = q << extra_hi
    low = e < 8
    top = e == 255  # length 258: symbol 285, no extra bits
    sym = jnp.where(low, 257 + e, jnp.where(top, 285, sym_hi))
    extra = jnp.where(low | top, 0, extra_hi)
    base = jnp.where(low, e, jnp.where(top, 255, base_hi))
    return sym, extra, base


def offset_sym_extra_base(oidx):
    """(symbol, extra_bits, base_offset) for the two-level offset index
    (raw_off < 256 ? raw_off : 256 + ((raw_off - 256) >> 7)) — equals
    OFFSET_SYMBOL/EXTRA_BITS/BASE[oidx] for every valid index 0..509."""
    oidx = oidx.astype(jnp.int32)
    j = jnp.where(oidx < 256, oidx, ((oidx - 256) << 7) + 256)
    k = jnp.maximum(floor_log2(jnp.maximum(j, 1)), 1)
    bit = (j >> (k - 1)) & 1
    low = j < 4
    sym = jnp.where(low, j, 2 * k + bit)
    extra = jnp.where(low, 0, k - 1)
    base = jnp.where(low, j + 1, ((2 + bit) << (k - 1)) + 1)
    return sym, extra, base


def select_by_symbol(table_rows, sym, lo: int, hi: int, init):
    """out[...] = table_rows[..., sym[...]] for sym ∈ [lo, hi) — an
    (hi-lo)-way elementwise select replacing a data-table gather. ``table_rows``
    is (..., S) broadcastable against ``sym``'s leading dims; entries
    with sym outside [lo, hi) get ``init``."""
    out = jnp.full(sym.shape, init, dtype=table_rows.dtype)
    for s in range(lo, hi):
        out = jnp.where(sym == s, table_rows[..., s : s + 1], out)
    return out
