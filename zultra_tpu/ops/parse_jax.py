"""Optimal-parse cost DP as a JAX scan.

The backward DP (reference src/blockdeflate.c:254-323; spec
zultra_tpu/parse.py) recast for XLA: a single ``lax.scan`` over positions
(reverse order) carrying a 259-slot ring of future costs,
with the 8 candidate matches × 37 truncated lengths evaluated as one
vectorized min-reduce per step using the same packed (cost<<6 | 63-k)
tie-break encoding as the native engine.

This is the semantically exact kernel used for cross-validation and small
blocks. The sequential dependence (cost[i] needs cost[i+1]) caps its
throughput on big blocks — the scan executes ~n steps. The device
planner runs ops/parse_wavefront._dp_scan_cost off the GPU and the CUDA
kernel of ops/dp_cuda on it.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..constants import (
    LEAVE_ALONE_MATCH_SIZE,
    MATCHLEN_EXTRA_BITS,
    MATCHLEN_SYMBOL,
    MIN_MATCH_SIZE,
    NMATCHES_PER_OFFSET,
    OFFSET_EXTRA_BITS,
    OFFSET_SYMBOL,
)

RING = 259  # cost lookback window: lengths up to 258 plus the literal step


@functools.partial(jax.jit, static_argnames=("length",))
def _dp_scan(lit_lens, off_lens, window, match_lens, match_offs, length):
    """Returns (best_len, best_off) int32 arrays of shape (length,).

    Inputs are the block's slices: window bytes, match lengths/offsets
    (length, 8). Position i in the arrays corresponds to absolute block
    position start+i; the scan walks backward.
    """
    n = length

    # Precompute per-position, per-candidate static costs.
    len_sym = jnp.asarray(np.asarray(MATCHLEN_SYMBOL))
    len_extra = jnp.asarray(np.asarray(MATCHLEN_EXTRA_BITS))
    off_sym = jnp.asarray(np.asarray(OFFSET_SYMBOL))
    off_extra = jnp.asarray(np.asarray(OFFSET_EXTRA_BITS))

    oidx_raw = match_offs - 1
    oidx = jnp.where(oidx_raw < 256, oidx_raw, 256 + ((oidx_raw - 256) >> 7))
    oidx = jnp.clip(oidx, 0, 511)
    offset_size = off_lens[off_sym[oidx]] + off_extra[oidx]  # (n, 8)

    lit_cost = lit_lens[window.astype(jnp.int32)]  # (n,)

    # Truncated-length candidate costs for k in [3, 40): packed with the
    # tie-break field (63 - k) so a plain min matches the reference's
    # downward strict scan.
    ks = jnp.arange(MIN_MATCH_SIZE, LEAVE_ALONE_MATCH_SIZE, dtype=jnp.int32)  # (37,)
    varlen_k = lit_lens[len_sym[ks - MIN_MATCH_SIZE]] + len_extra[ks - MIN_MATCH_SIZE]
    packed_k = (varlen_k << 6) | (63 - ks)  # (37,)

    def step(carry, inputs):
        ring, pos = carry  # ring[j] = cost[pos + 1 + j], j in [0, RING)
        lcost, mlens, moffs, osizes = inputs

        best_cost = lcost + ring[0]
        best_len = jnp.int32(0)
        best_off = jnp.int32(0)

        # Remaining length from this position (pos counts down from n-1).
        remaining = n - pos

        def eval_candidate(m, state):
            best_cost, best_len, best_off = state
            mlen = mlens[m]
            valid = mlen >= MIN_MATCH_SIZE
            clamped = jnp.minimum(mlen, remaining)
            osize = osizes[m]

            # Long-match path: single candidate at the clamped length.
            # Unsigned-wrap semantics: clamped < MIN maps to index 255.
            e_raw = clamped - MIN_MATCH_SIZE
            e = jnp.where((e_raw < 0) | (e_raw > 255), 255, e_raw)
            long_cost = (
                lit_lens[len_sym[e]] + len_extra[e] + osize
                + ring[jnp.clip(clamped - 1, 0, RING - 1)]
            )

            # Short-match path: min over k in [3, clamped].
            kmask = ks <= clamped
            future = ring[jnp.clip(ks - 1, 0, RING - 1)]
            packed = jnp.where(kmask, packed_k + (future << 6), jnp.int32(2**31 - 1))
            pmin = jnp.min(packed)
            short_cost = (pmin >> 6) + osize
            short_len = 63 - (pmin & 63)

            is_long = mlen >= LEAVE_ALONE_MATCH_SIZE
            cand_cost = jnp.where(is_long, long_cost, short_cost)
            cand_len = jnp.where(is_long, clamped, short_len)

            better = valid & (best_cost > cand_cost)
            return (
                jnp.where(better, cand_cost, best_cost),
                jnp.where(better, cand_len, best_len),
                jnp.where(better, moffs[m].astype(jnp.int32), best_off),
            )

        best_cost, best_len, best_off = lax.fori_loop(
            0, NMATCHES_PER_OFFSET, eval_candidate, (best_cost, best_len, best_off)
        )

        new_ring = jnp.concatenate([jnp.array([best_cost], jnp.int32), ring[:-1]])
        return (new_ring, pos - 1), (best_len, best_off)

    ring0 = jnp.zeros(RING, dtype=jnp.int32)
    inputs = (
        lit_cost[::-1],
        match_lens[::-1].astype(jnp.int32),
        match_offs[::-1].astype(jnp.int32),
        offset_size[::-1].astype(jnp.int32),
    )
    (_, _), (best_lens, best_offs) = lax.scan(step, (ring0, jnp.int32(n - 1)), inputs)
    return best_lens[::-1], best_offs[::-1]


def optimize_matches_jax(lit_lens, off_lens, window, match_table, start, end):
    """Drop-in DP: same inputs/outputs as the native zn_optimize_matches.
    Returns an (end, 2) int32 best-match array (rows < start are zero)."""
    length = end - start
    win = jnp.asarray(np.asarray(window[start:end], dtype=np.uint8))
    mt = np.asarray(match_table[start:end], dtype=np.int32)
    best_lens, best_offs = _dp_scan(
        jnp.asarray(np.asarray(lit_lens, dtype=np.int32)),
        jnp.asarray(np.asarray(off_lens, dtype=np.int32)),
        win,
        jnp.asarray(mt[:, :, 0]),
        jnp.asarray(mt[:, :, 1]),
        length,
    )
    out = np.zeros((end, 2), dtype=np.int32)
    out[start:end, 0] = np.asarray(best_lens)
    out[start:end, 1] = np.asarray(best_offs)
    return out
