"""Device token emission: the final DEFLATE bit-packing stage computed
without a sequential bit writer.

Replaces the semantics of the reference's token write loop
(reference src/blockdeflate.c:471-507 + the bitwriter
src/huffman/bitwriter.c:32-98) with a fully parallel construction:

  1. token starts — the greedy hop structure next(p) = p + max(len_p, 1)
     resolved by pointer doubling (log n rounds of jump composition),
     instead of the host's sequential walk;
  2. per-token emission lanes — each token contributes two lanes
     (literal/length codeword + length extra bits, offset codeword +
     offset extra bits), each ≤ 32 bits, value = codeword | extra << len;
  3. bit offsets — one exclusive prefix sum of the lane bit lengths
     (DEFLATE is LSB-first, so concatenation order IS stream order);
  4. packing — each lane scatter-adds its value into at most two uint32
     words; bit ranges are disjoint by construction so add == or.

Output is bit-identical to the host BitWriter path (tests/test_ops.py);
the end-of-data codeword is appended as a final lane. This is the last
compute stage of the begin-phase to get a device formulation (SA, match
finder, and the cost DP already have one); a full-device pipeline would
download only these packed words (~compressed size) instead of per-window
match tables.

It exists as the validated construction; the production planner emits
through ops/block_jax._emit_tokens.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..constants import (
    MATCHLEN_BASE,
    MATCHLEN_EXTRA_BITS,
    MATCHLEN_SYMBOL,
    MIN_MATCH_SIZE,
    NEODMARKERSYM,
    OFFSET_BASE,
    OFFSET_EXTRA_BITS,
    OFFSET_SYMBOL,
)


@functools.partial(jax.jit, static_argnames=("start", "end"))
def _emit_kernel(window, best_len, best_off, lit_cw, lit_len, off_cw, off_len,
                 start: int, end: int):
    n = end
    idx = jnp.arange(n, dtype=jnp.int32)

    # --- 1. token starts by pointer doubling ------------------------------
    step = jnp.where(best_len >= MIN_MATCH_SIZE, best_len, 1)
    nxt = jnp.minimum(idx + step, n)  # slot n is the sink
    jmp = jnp.concatenate([nxt, jnp.full((1,), n, jnp.int32)])
    mark = jnp.zeros(n + 1, jnp.int32).at[start].set(1)
    rounds = max(1, int(math.ceil(math.log2(n + 1))) + 1)
    for _ in range(rounds):
        mark = jnp.maximum(mark, jnp.zeros(n + 1, jnp.int32).at[jmp].max(
            mark, mode="drop"))
        jmp = jmp[jmp]
    is_tok = (mark[:n] == 1) & (idx >= start)

    # --- 2. per-token lanes ------------------------------------------------
    len_sym = jnp.asarray(np.asarray(MATCHLEN_SYMBOL, dtype=np.int32))
    len_extra = jnp.asarray(np.asarray(MATCHLEN_EXTRA_BITS, dtype=np.int32))
    len_base = jnp.asarray(np.asarray(MATCHLEN_BASE, dtype=np.int32))
    off_sym_t = jnp.asarray(np.asarray(OFFSET_SYMBOL, dtype=np.int32))
    off_extra_t = jnp.asarray(np.asarray(OFFSET_EXTRA_BITS, dtype=np.int32))
    off_base_t = jnp.asarray(np.asarray(OFFSET_BASE, dtype=np.int32))

    is_match = is_tok & (best_len >= MIN_MATCH_SIZE)
    e = jnp.clip(best_len - MIN_MATCH_SIZE, 0, 255)
    ls = len_sym[e]
    raw_off = jnp.maximum(best_off - 1, 0)
    oidx = jnp.where(raw_off < 256, raw_off, 256 + ((raw_off - 256) >> 7))
    oidx = jnp.clip(oidx, 0, 511)
    osym = off_sym_t[oidx]

    lit_v = lit_cw[window.astype(jnp.int32)]
    lit_n = lit_len[window.astype(jnp.int32)]

    m1_v = lit_cw[ls] | ((e - len_base[e]) << lit_len[ls])
    m1_n = lit_len[ls] + len_extra[e]
    m2_v = off_cw[osym] | ((best_off - off_base_t[oidx]) << off_len[osym])
    m2_n = off_len[osym] + off_extra_t[oidx]

    lane1_v = jnp.where(is_match, m1_v, jnp.where(is_tok, lit_v, 0))
    lane1_n = jnp.where(is_match, m1_n, jnp.where(is_tok, lit_n, 0))
    lane2_v = jnp.where(is_match, m2_v, 0)
    lane2_n = jnp.where(is_match, m2_n, 0)

    vals = jnp.stack([lane1_v, lane2_v], axis=1).reshape(-1)
    nbits = jnp.stack([lane1_n, lane2_n], axis=1).reshape(-1)
    vals = jnp.concatenate([vals, lit_cw[NEODMARKERSYM][None]])
    nbits = jnp.concatenate([nbits, lit_len[NEODMARKERSYM][None]])

    # --- 3. bit offsets -----------------------------------------------------
    offs_bits = jnp.cumsum(nbits) - nbits
    total_bits = offs_bits[-1] + nbits[-1]

    # --- 4. pack into uint32 words -----------------------------------------
    num_words = (16 * n + 64) // 32 + 2  # ≥ any token stream of n bytes...
    v = vals.astype(jnp.uint32)
    w = (offs_bits >> 5).astype(jnp.int32)
    sh = (offs_bits & 31).astype(jnp.uint32)
    lo = jnp.where(nbits > 0, (v << sh) & jnp.uint32(0xFFFFFFFF), jnp.uint32(0))
    hi = jnp.where((nbits > 0) & (sh > 0), v >> (jnp.uint32(32) - sh), jnp.uint32(0))
    words = jnp.zeros(num_words, jnp.uint32)
    words = words.at[w].add(lo, mode="drop")
    words = words.at[w + 1].add(hi, mode="drop")
    return words, total_bits


def write_tokens_jax(window, best, start: int, end: int,
                     lit_encoder, off_encoder):
    """Packed LSB-first token bitstream for block [start, end) — the
    device equivalent of the host token write loop. Returns (bytes,
    total_bits); byte-identical to a BitWriter emitting the same tokens
    at zero bit phase (the stream layer shifts whole blocks by phase).

    ``best``: (end, 2) int32 best-match array from any DP implementation;
    ``lit_encoder``/``off_encoder``: HuffmanEncoder-likes with built
    codewords (code_word pre-bit-reversed, as DEFLATE emits them).
    """
    window = np.asarray(window, dtype=np.uint8)
    best = np.asarray(best, dtype=np.int32)
    words, total_bits = _emit_kernel(
        jnp.asarray(window[:end]),
        jnp.asarray(best[:end, 0]),
        jnp.asarray(best[:end, 1]),
        jnp.asarray(np.asarray(lit_encoder.code_word, dtype=np.int32)),
        jnp.asarray(np.asarray(lit_encoder.code_length, dtype=np.int32)),
        jnp.asarray(np.asarray(off_encoder.code_word, dtype=np.int32)),
        jnp.asarray(np.asarray(off_encoder.code_length, dtype=np.int32)),
        start, end,
    )
    total_bits = int(total_bits)
    nbytes = (total_bits + 7) // 8
    raw = np.asarray(words).view(np.uint8)[:nbytes].copy()
    if total_bits & 7:
        raw[-1] &= (1 << (total_bits & 7)) - 1
    return raw.tobytes(), total_bits
