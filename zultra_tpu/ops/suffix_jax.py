"""Suffix array + PLCP on the device via prefix doubling.

The reference builds its SA with libdivsufsort's recursive induced sort —
branchy, pointer-heavy, and hostile to accelerators. The device
construction is Manber–Myers prefix doubling: ceil(log2 n) rounds of
(sort by (rank_i, rank_{i+k}), re-rank), where each round is a flat
device-wide sort + compare + cumsum — exactly the primitives XLA tiles
well. The output permutation is identical (the SA is unique), which the
tests assert against the native SA-IS and the O(n² log n) oracle.

PLCP uses the intermediate rank tables from the doubling rounds: the LCP
of two suffixes is recovered in O(log n) vectorized gathers by descending
the levels (standard rank-table LCP), evaluated for all Φ pairs at once —
no sequential Φ walk.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


def _num_levels(n: int) -> int:
    return max(1, int(math.ceil(math.log2(max(n, 2)))))


def _doubling_rounds(data: jnp.ndarray, n: int, levels: int,
                     store_levels: int | None = None):
    """Run prefix doubling; returns (sa, rank table per stored level).

    ranks[l] = ranks after sorting by 2^l-grams (l = 0 .. store_levels).
    Positions i, j share an equal 2^l-gram iff ranks[l][i] == ranks[l][j];
    this stays true for l past ``store_levels`` using the LAST stored row,
    because once suffix ranks are fully distinct no two positions share a
    longer gram either (clients that clamp LCPs — the staircase match
    finder clamps at 258 — pass store_levels=8 and save half the table).

    Every round is built from sorts and elementwise ops only:
      * one 3-array two-key sort (rank, rank2, idx) yields the sorted key
        columns AND the suffix order in one op (no post-sort gathers);
      * re-ranking returns to position order with a second sort keyed by
        the suffix order (a permutation sort replacing the scatter).
    Rounds past ``store_levels`` run under a while_loop that exits as soon
    as every rank is distinct (text converges around 2^6..2^8-grams, long
    before the ceil(log2 n) worst case); the skipped rounds are identities.
    """
    if store_levels is None or store_levels > levels:
        store_levels = levels
    idx = jnp.arange(n, dtype=jnp.int32)
    neg = jnp.full((n,), jnp.int32(-1))

    def rerank(k1, k2, sa):
        """New ranks (position order) + all-distinct flag from sorted keys."""
        diff = jnp.concatenate(
            [
                jnp.zeros(1, jnp.int32),
                ((k1[1:] != k1[:-1]) | (k2[1:] != k2[:-1])).astype(jnp.int32),
            ]
        )
        r_sorted = jnp.cumsum(diff)
        distinct = r_sorted[-1] == n - 1
        _, rank = lax.sort((sa, r_sorted), num_keys=1)
        return rank, distinct

    # Level 0: the raw symbol values ARE a width-1 comparison table (every
    # consumer tests equality / lexicographic order only), so the first
    # doubling round sorts (symbol, next symbol) directly — no separate
    # level-0 ranking pass.
    rank = data.astype(jnp.int32)
    distinct = jnp.bool_(False)

    rows = [rank]
    for level in range(min(levels, store_levels)):
        k = 1 << level
        rank2 = jnp.concatenate([rank[k:], neg[:k]])
        k1, k2, sa = lax.sort((rank, rank2, idx), num_keys=2)
        rank, distinct = rerank(k1, k2, sa)
        rows.append(rank)

    if levels > store_levels:
        rank_pad_tail = neg  # -1 past the end, fetched via a padded slice

        def w_cond(state):
            _, _, k, done = state
            return (~done) & (k < (1 << levels))

        def w_body(state):
            sa_c, rank, k, _ = state
            padded = jnp.concatenate([rank, rank_pad_tail])
            rank2 = lax.dynamic_slice(padded, (k,), (n,))
            k1, k2, sa_c = lax.sort((rank, rank2, idx), num_keys=2)
            rank, distinct = rerank(k1, k2, sa_c)
            return sa_c, rank, k * 2, distinct

        sa, rank, _, _ = lax.while_loop(
            w_cond, w_body, (sa, rank, jnp.int32(1 << store_levels), distinct)
        )
    return sa, jnp.stack(rows)


def _suffix_array_impl(data: jnp.ndarray, levels: int):
    n = data.shape[0]
    sa, _ = _doubling_rounds(data, n, levels)
    return sa


@jax.jit
def _sa_jit_1(data):
    return _suffix_array_impl(data, _num_levels(data.shape[0]))


def suffix_array_jax(data) -> np.ndarray:
    """Suffix array of a byte array on the default JAX device."""
    n = int(np.shape(data)[0])
    if n == 0:
        return np.empty(0, dtype=np.int32)
    if n == 1:
        return np.zeros(1, dtype=np.int32)
    arr = jnp.asarray(np.asarray(data, dtype=np.uint8))
    return np.asarray(_sa_jit_1(arr))


def _plcp_impl(data: jnp.ndarray, levels: int):
    """PLCP for all positions via rank-table LCP over the Φ pairs."""
    n = data.shape[0]
    sa, ranks = _doubling_rounds(data, n, levels)

    # Φ: predecessor of each suffix in SA order (root -> itself, masked out).
    phi = jnp.zeros(n, dtype=jnp.int32).at[sa[1:]].set(sa[:-1])
    root = sa[0]
    phi = phi.at[root].set(root)

    i_pos = jnp.arange(n, dtype=jnp.int32)
    j_pos = phi

    # Descend levels: if the 2^l-grams at (i+l_acc, j+l_acc) agree, extend.
    # ranks[l][p] compares 2^l-grams (level 0 = single byte).
    lcp = jnp.zeros(n, dtype=jnp.int32)

    def level_body(carry, level_rank_and_width):
        lcp = carry
        level_rank, width = level_rank_and_width
        ia = i_pos + lcp
        ja = j_pos + lcp
        # Valid only if both windows fit; compare ranks.
        ok = (ia + width <= n) & (ja + width <= n)
        ra = level_rank[jnp.clip(ia, 0, n - 1)]
        rb = level_rank[jnp.clip(ja, 0, n - 1)]
        lcp = jnp.where(ok & (ra == rb), lcp + width, lcp)
        return lcp, None

    widths = jnp.array([1 << l for l in range(levels, -1, -1)], dtype=jnp.int32)
    # ranks stacked as [levels+1, n]; iterate from coarsest to finest.
    stacked = ranks[::-1]
    lcp, _ = lax.scan(level_body, lcp, (stacked, widths))

    lcp = jnp.where(i_pos == root, 0, lcp)
    return lcp


@jax.jit
def _plcp_jit(data):
    return _plcp_impl(data, _num_levels(data.shape[0]))


def plcp_jax(data) -> np.ndarray:
    """Permuted LCP array (lcp of each suffix with its SA predecessor)."""
    n = int(np.shape(data)[0])
    if n < 2:
        return np.zeros(n, dtype=np.int32)
    arr = jnp.asarray(np.asarray(data, dtype=np.uint8))
    return np.asarray(_plcp_jit(arr))
