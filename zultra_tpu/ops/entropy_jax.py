"""Device entropy estimation: batched Moffat–Katajainen code lengths and
the dynamic-cost estimator, as used by the block splitter and the
static/dynamic block choice.

Replaces the semantics of the reference's cost-estimation path
(reference src/huffman/huffencoder.c:157-270 MK lengths,
src/blockdeflate.c:577-618 dynamic cost incl. the CL-table RLE walk
src/huffman/huffencoder.c:446-735) with batched device formulations:

* ``mk_lengths``: MK phases 1-2 are inherently sequential two-pointer /
  parent-chain walks — they run as ``lax.scan``s over the (tiny, ≤288)
  symbol axis with the candidate batch as vector lanes, so evaluating
  2000 histograms costs the same wall clock as one. Phase 3 (depth
  counting) is NOT scanned: the reference's avail/seen loop has a closed
  form — internal-depth histogram → leaves_at[d] = 2·internal_at[d-1] −
  internal_at[d] — evaluated with one scatter and two scans.
* ``rle_stats``: the CL-table RLE walk has a per-run closed form (runs
  never interact across boundaries), so histogram and bit-size
  accounting vectorize over runs with no scan at all; the mask-7/8
  special cases and the mask bit gates are static parameters.
* ``dynamic_cost``: symbol cost + 14 header bits + 3·raw_table_size +
  the mask-31 RLE size + 3, batched.

Exactness: every tie-break (sort by (weight, symbol), strict phase-1
comparisons, ≤1-used-symbol quirk pinning the 1-bit code to symbol 0)
is reproduced; tests/test_ops.py checks bit-identity against the host
HuffmanEncoder on randomized histograms.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..constants import (
    CODELEN_SYM_ORDER,
    NCODELENSYMS,
    NLITERALSYMS,
    NOFFSETSYMS,
    REV_MATCHLEN_SYMBOL_BITS,
    REV_OFFSET_SYMBOL_BITS,
)

INF32 = jnp.int32(2**30)


def mk_lengths(hist: jnp.ndarray) -> jnp.ndarray:
    """Batched Moffat–Katajainen minimum-redundancy code lengths.

    ``hist``: (B, S) int32 symbol populations. Returns (B, S) int32 code
    lengths, UNLIMITED (no Kraft clamping), bit-identical to
    HuffEncoder::estimate_dynamic_codelens (entropy.hpp:100-149)
    including the ≤1-used-symbol quirk (all lengths 0, length[0] = 1).
    """
    B, S = hist.shape
    used = hist > 0
    n_used = jnp.sum(used.astype(jnp.int32), axis=1)  # (B,)

    # Sort used symbols by (weight, symbol); unused sink to the end.
    idx = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
    key = jnp.where(used, hist, INF32)
    key_sorted, queue = lax.sort((key, idx), dimension=1, num_keys=2)
    a0 = jnp.where(key_sorted < INF32, key_sorted, 0)  # sorted weights

    # ---- phase 1: two-queue merge, scan over t = 0..S-2 ------------------
    # Every step is O(B): per-lane gathers at the two queue heads, one
    # drop-masked scatter for the consumed internal node, one column
    # write for a[t]. (An O(B·S) masked select per step would move
    # 287 steps × B×S×8 B of device memory traffic.)
    def pick(a, leaf, internal, t, w_acc, active):
        av_leaf = jnp.take_along_axis(a, jnp.clip(leaf, 0, S - 1)[:, None], axis=1)[:, 0]
        av_int = jnp.take_along_axis(a, jnp.clip(internal, 0, S - 1)[:, None], axis=1)[:, 0]
        take_int = ((leaf >= n_used) | ((internal < t) & (av_int < av_leaf))) & active
        w_acc = w_acc + jnp.where(take_int, av_int, av_leaf)
        # a[internal] = t + 1 where an internal node was consumed; inactive
        # lanes scatter out of range (dropped).
        a = a.at[
            jnp.arange(a.shape[0]), jnp.where(take_int, internal, S)
        ].set(t + 1, mode="drop")
        internal = internal + take_int.astype(jnp.int32)
        leaf = leaf + (active & ~take_int).astype(jnp.int32)
        return a, leaf, internal, w_acc

    def _dyn_col(a, t):
        return lax.dynamic_slice(a, (0, t), (B, 1))[:, 0]

    def phase1_step(carry, t):
        a, leaf, internal = carry
        active = t < n_used - 1
        a, leaf, internal, w = pick(a, leaf, internal, t, jnp.zeros(B, jnp.int32), active)
        a, leaf, internal, w = pick(a, leaf, internal, t, w, active)
        # a[t] = w (same t for every lane; inactive lanes keep a[t]).
        a = lax.dynamic_update_slice(
            a, jnp.where(active, w, _dyn_col(a, t))[:, None], (0, t)
        )
        return (a, leaf, internal), None

    (a, _, _), _ = lax.scan(
        phase1_step,
        (a0, jnp.zeros(B, jnp.int32), jnp.zeros(B, jnp.int32)),
        jnp.arange(S - 1, dtype=jnp.int32),
    )

    # ---- phase 2: internal depths via the parent chain -------------------
    # a[n-2] = 0 (root), then a[t] = a[a[t]-1] + 1 backwards. Parents
    # have larger indices, so a backward scan resolves each in one step.
    root = jnp.clip(n_used - 2, 0, S - 1)
    a = jnp.where(jnp.arange(S)[None, :] == root[:, None], 0, a)

    def phase2_step(a, t):
        active = t <= n_used - 3
        parent = _dyn_col(a, t) - 1
        pdepth = jnp.take_along_axis(a, jnp.clip(parent, 0, S - 1)[:, None], axis=1)[:, 0]
        newv = jnp.where(active, pdepth + 1, _dyn_col(a, t))
        a = lax.dynamic_update_slice(a, newv[:, None], (0, t))
        return a, None

    a, _ = lax.scan(
        phase2_step, a, jnp.arange(S - 3, -1, -1, dtype=jnp.int32)
    )

    # ---- phase 3: closed form ---------------------------------------------
    # internal_at[d] over t < n_used-1; avail[d] = 2*internal_at[d-1],
    # avail[0] = 1; leaves_at[d] = avail[d] - internal_at[d]. Leaf depths
    # fill positions r = 0.. (deepest leaves go to the smallest weights:
    # r = n_used-1 - i for sorted leaf i).
    t_in = jnp.arange(S)[None, :] < (n_used - 1)[:, None]
    depth_clip = jnp.clip(a, 0, S - 1)
    internal_at = jnp.zeros((B, S + 1), jnp.int32).at[
        jnp.arange(B)[:, None], jnp.where(t_in, depth_clip, S)
    ].add(1)[:, :S]
    avail = jnp.concatenate(
        [jnp.ones((B, 1), jnp.int32), 2 * internal_at[:, :-1]], axis=1
    )
    leaves_at = avail - internal_at  # (B, S), ≥ 0 rows valid
    cum_excl = jnp.cumsum(leaves_at, axis=1) - leaves_at  # leaves deeper... start r
    # Scatter depth d at fill position cum_excl[d] where leaves exist, then
    # forward-fill (depths ascend with r) with a running max.
    fill = jnp.full((B, S + 1), -1, jnp.int32).at[
        jnp.arange(B)[:, None],
        jnp.where(leaves_at > 0, jnp.clip(cum_excl, 0, S - 1), S),
    ].max(jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None, :], (B, S)))[:, :S]
    depth_of_r = lax.cummax(fill, axis=1)
    # sorted-leaf i gets depth_of_r[n_used-1-i]
    r_of_i = jnp.clip(n_used[:, None] - 1 - jnp.arange(S)[None, :], 0, S - 1)
    len_sorted = jnp.take_along_axis(depth_of_r, r_of_i, axis=1)
    len_sorted = jnp.where(jnp.arange(S)[None, :] < n_used[:, None], len_sorted, 0)

    # Map back to symbol order: lengths[queue[i]] = len_sorted[i].
    lengths = jnp.zeros((B, S), jnp.int32).at[
        jnp.arange(B)[:, None], queue
    ].set(len_sorted)

    # ≤1 used symbol: all zero except lengths[0] = 1.
    few = (n_used <= 1)[:, None]
    quirk = jnp.where(jnp.arange(S)[None, :] == 0, 1, 0)
    return jnp.where(few, quirk, lengths)


def _run_structure(lens: jnp.ndarray, n_def: jnp.ndarray):
    """Maximal-run decomposition of each lane's first n_def entries.
    Returns (is_start, run_len, value) — run_len/value meaningful at
    starts."""
    B, L = lens.shape
    pos = jnp.arange(L, dtype=jnp.int32)[None, :]
    valid = pos < n_def[:, None]
    prev = jnp.concatenate([jnp.full((B, 1), -1, lens.dtype), lens[:, :-1]], axis=1)
    is_start = valid & ((pos == 0) | (lens != prev))
    # Next start position (or n_def) via a reverse running min.
    nxt_candidate = jnp.where(is_start, pos, INF32)
    nxt = lax.cummin(
        jnp.concatenate([nxt_candidate[:, 1:], jnp.full((B, 1), INF32, jnp.int32)], axis=1)[:, ::-1],
        axis=1,
    )[:, ::-1]
    run_end = jnp.minimum(nxt, n_def[:, None])
    run_len = jnp.where(is_start, run_end - pos, 0)
    return is_start, run_len, lens


def _run_counts(value, r, mask: int):
    """Per-run RLE emission counts under a static ``mask``; mirrors
    walk_var_lengths (entropy.hpp:244-291). Returns (n16, n17, n18,
    lit_count, lit_value) — lit_value is the clamped on_lit argument."""
    zero = value == 0
    # --- zero runs --------------------------------------------------------
    r3 = r >= 3
    if mask & 4:
        ge11 = r >= 11
        q = r // 138
        rem = r % 138
        n18 = jnp.where(r3 & ge11, q + (rem >= 11), 0)
        after18 = jnp.where(r3 & ge11, jnp.where(rem >= 11, 0, rem), r)
    else:
        n18 = jnp.zeros_like(r)
        after18 = r
    if mask & 2:
        q10 = after18 // 10
        rem10 = after18 % 10
        n17 = jnp.where(r3 & (after18 >= 3), q10 + (rem10 >= 3), 0)
        after17 = jnp.where(
            r3 & (after18 >= 3), jnp.where(rem10 >= 3, 0, rem10), after18
        )
    else:
        n17 = jnp.zeros_like(r)
        after17 = after18
    z_lit = after17  # leftover zeros emitted singly

    # --- nonzero runs -----------------------------------------------------
    vclamp = jnp.minimum(value, 15)
    rp = r - 1
    if mask & 1:
        s7 = (rp == 7) if not (mask & 8) else jnp.zeros_like(rp, bool)
        s8 = (rp == 8) if not (mask & 16) else jnp.zeros_like(rp, bool)
        q6 = rp // 6
        rem6 = rp % 6
        n16_gen = q6 + (rem6 >= 3)
        left_gen = jnp.where(rem6 < 3, rem6, 0)
        n16 = jnp.where(s7 | s8, 2, n16_gen)
        nz_left = jnp.where(s7 | s8, 0, left_gen)
    else:
        n16 = jnp.zeros_like(rp)
        nz_left = rp
    nz_lit = 1 + nz_left  # first emission + leftover singles

    n16 = jnp.where(zero, 0, n16)
    n17 = jnp.where(zero, n17, 0)
    n18 = jnp.where(zero, n18, 0)
    lit_count = jnp.where(zero, z_lit, nz_lit)
    lit_value = jnp.where(zero, 0, vclamp)
    return n16, n17, n18, lit_count, lit_value


def rle_histogram(lens: jnp.ndarray, n_def: jnp.ndarray, mask: int) -> jnp.ndarray:
    """CL-symbol histogram of the RLE walk over each lane's lengths —
    update_var_lengths_entropy (entropy.hpp:293-299), batched.
    ``lens``: (B, L) raw (possibly >15) lengths; ``n_def``: (B,)."""
    B, L = lens.shape
    is_start, r, v = _run_structure(lens, n_def)
    n16, n17, n18, lit_c, lit_v = _run_counts(v, jnp.maximum(r, 1), mask)
    z = jnp.zeros_like(r)
    n16 = jnp.where(is_start, n16, z)
    n17 = jnp.where(is_start, n17, z)
    n18 = jnp.where(is_start, n18, z)
    lit_c = jnp.where(is_start, lit_c, z)
    hist = jnp.zeros((B, NCODELENSYMS + 1), jnp.int32)
    lane = jnp.arange(B)[:, None]
    hist = hist.at[lane, jnp.where(is_start, jnp.clip(lit_v, 0, 15), NCODELENSYMS)].add(lit_c)
    hist = hist.at[:, 16].add(jnp.sum(n16, axis=1))
    hist = hist.at[:, 17].add(jnp.sum(n17, axis=1))
    hist = hist.at[:, 18].add(jnp.sum(n18, axis=1))
    return hist[:, :NCODELENSYMS]


def rle_bits(lens: jnp.ndarray, n_def: jnp.ndarray, te_lens: jnp.ndarray, mask: int) -> jnp.ndarray:
    """Bit size of the RLE-coded table under CL code lengths ``te_lens``
    (B, 19) — get_var_lengths_size (entropy.hpp:301-309), batched."""
    B, L = lens.shape
    is_start, r, v = _run_structure(lens, n_def)
    n16, n17, n18, lit_c, lit_v = _run_counts(v, jnp.maximum(r, 1), mask)
    z = jnp.zeros_like(r)
    n16 = jnp.where(is_start, n16, z)
    n17 = jnp.where(is_start, n17, z)
    n18 = jnp.where(is_start, n18, z)
    lit_c = jnp.where(is_start, lit_c, z)
    lit_len = jnp.take_along_axis(
        te_lens, jnp.clip(lit_v, 0, 15), axis=1
    )  # (B, L)
    bits = jnp.sum(lit_c * lit_len, axis=1)
    bits = bits + jnp.sum(n16, axis=1) * (te_lens[:, 16] + 2)
    bits = bits + jnp.sum(n17, axis=1) * (te_lens[:, 17] + 3)
    bits = bits + jnp.sum(n18, axis=1) * (te_lens[:, 18] + 7)
    return bits


def raw_table_size(te_lens: jnp.ndarray) -> jnp.ndarray:
    """HuffEncoder::raw_table_size — CL lengths in transmission order,
    trailing zeros trimmed, minimum 4. (B, 19) -> (B,)."""
    order = jnp.asarray(np.asarray(CODELEN_SYM_ORDER, dtype=np.int32))
    in_order = te_lens[:, order]  # (B, 19)
    posp1 = jnp.arange(1, NCODELENSYMS + 1, dtype=jnp.int32)[None, :]
    last = jnp.max(jnp.where(in_order != 0, posp1, 0), axis=1)
    return jnp.maximum(last, 4)


def defined_count(lens: jnp.ndarray, min_symbols: int) -> jnp.ndarray:
    """HuffEncoder::defined_var_lengths_count, batched."""
    S = lens.shape[1]
    posp1 = jnp.arange(1, S + 1, dtype=jnp.int32)[None, :]
    last = jnp.max(jnp.where(lens != 0, posp1, 0), axis=1)
    return jnp.maximum(last, min_symbols)


def _floor_log2(x):
    """floor(log2(x)) for x >= 1 (int32)."""
    return 31 - lax.clz(jnp.maximum(x, 1))


def limited_lengths(lengths: jnp.ndarray, max_len: int) -> jnp.ndarray:
    """Kraft-sum length limiting — the repair half of
    build_dynamic_codewords (entropy.hpp:151-200; reference
    huffencoder.c:279-346), batched.

    ``lengths``: (B, S) int32 *unlimited* MK code lengths (zeros =
    unused). Returns (B, S) limited lengths, bit-identical to the host:
    clamp overlong codes, lengthen the rarest symbols (reverse
    (length, symbol) order) until the Kraft sum fits, then re-shorten
    the most frequent ones while room remains. The sequential inner
    ``while`` loops collapse to closed forms: k increments starting at
    length l change the Kraft sum by (full>>l) - (full>>(l+k)), so the
    stopping length is a floor_log2 of the remaining surplus; k
    decrements add (full>>l)·(2^k - 1), so the step count is a
    floor_log2 of the remaining headroom. The symbol sweep itself is a
    scan carrying the Kraft sum."""
    B, S = lengths.shape
    full = jnp.int32(1 << max_len)
    used = lengths > 0
    over = jnp.max(lengths, axis=1) > max_len  # (B,) lanes needing repair

    # Sorted (length, symbol) ascending over used symbols; unused sink.
    key = jnp.where(used, lengths * S + jnp.arange(S)[None, :], INF32)
    _, order = lax.sort((key, jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))),
                        dimension=1, num_keys=1)
    n_used = jnp.sum(used.astype(jnp.int32), axis=1)

    lane = jnp.arange(B)
    lens_sorted = jnp.take_along_axis(lengths, order, axis=1)
    clamped = jnp.minimum(lens_sorted, max_len)
    in_used = jnp.arange(S)[None, :] < n_used[:, None]
    kraft0 = jnp.sum(jnp.where(in_used, full >> clamped, 0), axis=1)

    # Phase A: lengthen rarest (descending sorted position) while
    # kraft > full.
    def lengthen(carry, p):
        kraft, lens = carry
        l = lens[lane, p]
        active = (p < n_used) & (kraft > full) & (l < max_len)
        r = (full >> l) - (kraft - full)
        l_new = jnp.where(
            r <= 0, max_len, jnp.maximum(l, max_len - _floor_log2(r))
        )
        l_new = jnp.where(active, jnp.minimum(l_new, max_len), l)
        kraft = kraft - (full >> l) + (full >> l_new)
        lens = lens.at[lane, p].set(l_new)
        return (kraft, lens), None

    (kraft, lens_a), _ = lax.scan(
        lengthen, (kraft0, clamped), jnp.arange(S - 1, -1, -1, dtype=jnp.int32)
    )

    # Phase B: re-shorten most frequent (ascending sorted position)
    # while kraft + (full >> l) <= full.
    def shorten(carry, p):
        kraft, lens = carry
        l = lens[lane, p]
        active = p < n_used
        u = full >> l
        m = jnp.maximum(full - kraft, 0) // jnp.maximum(u, 1)
        d = jnp.where(active, _floor_log2(m + 1), 0)
        d = jnp.minimum(d, jnp.maximum(l - 1, 0))  # never reach length 0
        kraft = kraft + u * ((1 << d) - 1)
        lens = lens.at[lane, p].set(l - d)
        return (kraft, lens), None

    (_, lens_b), _ = lax.scan(
        shorten, (kraft, lens_a), jnp.arange(S, dtype=jnp.int32)
    )

    # Scatter back to symbol order; untouched lanes keep the input.
    repaired = jnp.zeros((B, S), jnp.int32).at[lane[:, None], order].set(
        jnp.where(in_used, lens_b, 0)
    )
    return jnp.where(over[:, None], repaired, lengths)


def build_lengths(hist: jnp.ndarray, max_len: int) -> jnp.ndarray:
    """MK lengths + Kraft limiting — the length half of
    build_dynamic_codewords, batched."""
    return limited_lengths(mk_lengths(hist), max_len)


_REV_S = [
    (0x5555, 0xAAAA, 1), (0x3333, 0xCCCC, 2), (0x0F0F, 0xF0F0, 4), (0x00FF, 0xFF00, 8),
]


def _reverse_bits16_jnp(word, nbits):
    w = word
    for lo, hi, sh in _REV_S:
        w = ((w & lo) << sh) | ((w & hi) >> sh)
    return jnp.where(nbits > 0, w >> (16 - jnp.minimum(nbits, 16)), 0)


def canonical_codewords(lengths: jnp.ndarray) -> jnp.ndarray:
    """Canonical bit-reversed codewords from (limited) code lengths —
    HuffEncoder::issue_canonical over (length, symbol) order
    (entropy.hpp:202-219), batched. Zero-length symbols get codeword 0.

    The sequential word walk equals standard canonical assignment:
    next_code[d] = (next_code[d-1] + count[d-1]) << 1, codeword =
    reverse(next_code[len] + rank_within_len)."""
    B, S = lengths.shape
    used = lengths > 0
    MAXL = 16  # code lengths are <= 15 everywhere
    lane = jnp.arange(B)[:, None]
    cnt = jnp.zeros((B, MAXL + 1), jnp.int32).at[
        lane, jnp.where(used, jnp.clip(lengths, 0, MAXL), 0)
    ].add(jnp.where(used, 1, 0))
    # next_code[d] = (next_code[d-1] + cnt[d-1]) << 1, next_code[0] = 0.
    def nc_step(code, d):
        code = (code + cnt[:, d - 1]) << 1
        return code, code
    _, nc = lax.scan(nc_step, jnp.zeros(B, jnp.int32),
                     jnp.arange(1, MAXL + 1, dtype=jnp.int32))
    next_code = jnp.concatenate([jnp.zeros((1, B), jnp.int32), nc]).T  # (B, 17)

    # rank within length = sorted position - cumulative count of shorter.
    key = jnp.where(used, lengths * S + jnp.arange(S)[None, :], INF32)
    _, order = lax.sort(
        (key, jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))),
        dimension=1, num_keys=1,
    )
    pos = jnp.zeros((B, S), jnp.int32).at[lane, order].set(
        jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
    )
    cum_shorter = jnp.cumsum(cnt, axis=1) - cnt  # (B, 17): count of lengths < d
    rank = pos - jnp.take_along_axis(cum_shorter, jnp.clip(lengths, 0, MAXL), axis=1)
    word = jnp.take_along_axis(next_code, jnp.clip(lengths, 0, MAXL), axis=1) + rank
    return jnp.where(used, _reverse_bits16_jnp(word, lengths), 0)


def optimize_for_rle_jax(counts: jnp.ndarray) -> jnp.ndarray:
    """Zopfli-style histogram rewrite — optimize_histogram_for_rle
    (huffman.py:367-419; reference huffutils.c:34-114), batched over
    lanes. All decisions read the ORIGINAL counts (writes only ever land
    behind the cursor), so the sequential pass splits into a decision
    scan plus one vectorized segment rewrite."""
    B, L = counts.shape
    pos = jnp.arange(L, dtype=jnp.int32)[None, :]

    # 1) effective length: trailing zeros stay untouched.
    eff = jnp.max(jnp.where(counts != 0, pos + 1, 0), axis=1)  # (B,)
    in_len = pos < eff[:, None]

    # 2) good_for_rle: zero runs >= 5, nonzero runs >= 7 (within eff).
    prev = jnp.concatenate([jnp.full((B, 1), -1, counts.dtype), counts[:, :-1]], axis=1)
    is_start = in_len & ((pos == 0) | (counts != prev))
    nxt_start = jnp.where(is_start, pos, INF32)
    nxt = lax.cummin(
        jnp.concatenate([nxt_start[:, 1:], jnp.full((B, 1), INF32, jnp.int32)], axis=1)[:, ::-1],
        axis=1,
    )[:, ::-1]
    run_len = jnp.minimum(nxt, eff[:, None]) - pos  # valid at starts
    good_start = is_start & jnp.where(
        counts == 0, run_len >= 5, run_len >= 7
    )
    # Propagate the start's goodness across its run (forward fill).
    start_pos = lax.cummax(jnp.where(is_start, pos, -1), axis=1)
    good_at = jnp.zeros((B, L), jnp.int32).at[
        jnp.arange(B)[:, None], jnp.where(is_start, pos, 0)
    ].max(good_start.astype(jnp.int32))
    good = in_len & (
        jnp.take_along_axis(good_at, jnp.clip(start_pos, 0, L - 1), axis=1) > 0
    )

    # 3) decision scan over i = 0..eff (inclusive); carry (stride, limit,
    # total); emit (write_start, value, valid) at boundaries.
    c_ext = jnp.concatenate([counts, jnp.zeros((B, 4), counts.dtype)], axis=1)
    limit4 = (c_ext[:, :L] + c_ext[:, 1:L+1] + c_ext[:, 2:L+2] + c_ext[:, 3:L+3] + 2) // 4
    good_ext = jnp.concatenate([good, jnp.zeros((B, 1), jnp.bool_)], axis=1)

    def step(carry, i):
        stride, limit, total = carry
        at_end = i == eff
        inside = i < eff
        ci = c_ext[:, i]
        boundary = at_end | (inside & (good_ext[:, i] | (jnp.abs(ci - limit) >= 4)))
        do_write = boundary & ((stride >= 4) | ((stride >= 3) & (total == 0)))
        val = jnp.maximum((total + stride // 2) // jnp.maximum(stride, 1), 1)
        val = jnp.where(total == 0, 0, val)
        w_start = i - stride
        # new limit (only at boundaries)
        lim_new = jnp.where(
            i < eff - 3, limit4[:, jnp.minimum(i, L - 1)],
            jnp.where(i < eff, ci, 0),
        )
        limit = jnp.where(boundary, lim_new, limit)
        stride = jnp.where(boundary, 0, stride) + jnp.where(i <= eff, 1, 0)
        total = jnp.where(boundary, 0, total) + jnp.where(inside, ci, 0)
        return (stride, limit, total), (do_write & (i <= eff), w_start, val, i)

    init = (jnp.zeros(B, jnp.int32), c_ext[:, 0].astype(jnp.int32), jnp.zeros(B, jnp.int32))
    _, (wr, wstart, wval, wend) = lax.scan(
        step, init, jnp.arange(L + 1, dtype=jnp.int32)
    )
    wr, wstart, wval, wend = wr.T, wstart.T, wval.T, wend.T  # (B, L+1)

    # Rewrite segments [wstart, wend): scatter (end, val) at their start
    # positions, then assign each position to the latest write-start at or
    # before it (segments are disjoint, so starts are unique).
    lane = jnp.arange(B)[:, None]
    ws = jnp.where(wr, jnp.clip(wstart, 0, L - 1), 0)
    end_at = jnp.full((B, L), -1, jnp.int32).at[lane, ws].max(
        jnp.where(wr, wend, -1)
    )
    val_at = jnp.full((B, L), -1, jnp.int32).at[lane, ws].max(
        jnp.where(wr, wval, -1)
    )
    wkey = lax.cummax(jnp.where(end_at >= 0, pos, -1), axis=1)
    wkey_c = jnp.clip(wkey, 0, L - 1)
    covered = (wkey >= 0) & (pos < jnp.take_along_axis(end_at, wkey_c, axis=1))
    fill_val = jnp.take_along_axis(val_at, wkey_c, axis=1)
    return jnp.where((eff[:, None] > 0) & covered, fill_val, counts)


def static_cost(lit_hist: jnp.ndarray, off_hist: jnp.ndarray) -> jnp.ndarray:
    """evaluate_static_cost (blocks.py:72-84; reference
    src/blockdeflate.c:538-566), batched."""
    from ..constants import static_literal_code_lengths

    static_lit = jnp.asarray(
        np.asarray(static_literal_code_lengths(), dtype=np.int32)
    )
    rev_len = jnp.asarray(np.asarray(REV_MATCHLEN_SYMBOL_BITS, dtype=np.int32))
    extra = jnp.concatenate(
        [jnp.zeros(257, jnp.int32), rev_len,
         jnp.zeros(NLITERALSYMS - 257 - rev_len.shape[0], jnp.int32)]
    )
    counted = jnp.where(
        jnp.arange(NLITERALSYMS)[None, :] < 257 + rev_len.shape[0], lit_hist, 0
    )
    rev_off = jnp.asarray(np.asarray(REV_OFFSET_SYMBOL_BITS, dtype=np.int32))
    cost = jnp.sum(counted * (static_lit[None, :] + extra[None, :]), axis=1)
    cost = cost + jnp.sum(off_hist * (5 + rev_off[None, :]), axis=1)
    return cost + 3


def _concat_lengths(lit_len: jnp.ndarray, off_len: jnp.ndarray):
    """concat(lit_len[:n_lit], off_len[:n_off]) as fixed (B, 320) +
    n_def, shared by the cost estimators and the mask search."""
    n_lit = defined_count(lit_len, 257)
    n_off = defined_count(off_len, 1)
    L = NLITERALSYMS + NOFFSETSYMS
    j = jnp.arange(L, dtype=jnp.int32)[None, :]
    from_off = j >= n_lit[:, None]
    oidx = jnp.clip(j - n_lit[:, None], 0, NOFFSETSYMS - 1)
    lens = jnp.where(
        from_off,
        jnp.take_along_axis(off_len, oidx, axis=1),
        jnp.take_along_axis(lit_len, jnp.clip(j, 0, NLITERALSYMS - 1), axis=1),
    )
    return lens, n_lit, n_off, n_lit + n_off


def dynamic_cost_given(lit_hist, off_hist, lit_len, off_len) -> jnp.ndarray:
    """evaluate_dynamic_cost with GIVEN (limited) code lengths
    (blocks.py:87-119) — used by the RLE A/B test; ``dynamic_cost``
    below is the estimator variant that derives unlimited MK lengths
    itself."""
    rev_len = jnp.asarray(np.asarray(REV_MATCHLEN_SYMBOL_BITS, dtype=np.int32))
    rev_off = jnp.asarray(np.asarray(REV_OFFSET_SYMBOL_BITS, dtype=np.int32))
    extra_lit = jnp.concatenate(
        [jnp.zeros(257, jnp.int32), rev_len,
         jnp.zeros(NLITERALSYMS - 257 - rev_len.shape[0], jnp.int32)]
    )
    lit_counted = jnp.where(
        jnp.arange(NLITERALSYMS)[None, :] < 257 + rev_len.shape[0], lit_hist, 0
    )
    cost = jnp.sum(lit_counted * (lit_len + extra_lit[None, :]), axis=1)
    cost = cost + jnp.sum(off_hist * (off_len + rev_off[None, :]), axis=1)

    lens, _, _, n_def = _concat_lengths(lit_len, off_len)
    te_hist = rle_histogram(lens, n_def, 7)
    te_len = mk_lengths(te_hist)
    cost = cost + 5 + 5 + 4
    cost = cost + 3 * raw_table_size(te_len)
    cost = cost + rle_bits(lens, n_def, te_len, 31)
    return cost + 3


_MASK_ORDER = tuple(list(range(8)) + list(range(9, 32, 2)))


def mask_search(lit_len: jnp.ndarray, off_len: jnp.ndarray):
    """The CL-code mask search (blocks.py:327-351; reference
    src/blockdeflate.c:958-977), batched: evaluate every mask in the
    reference order (0..7 then odd 9..31), later masks win cost ties.
    Returns (best_mask (B,), cl_len (B,19) limited CL lengths for the
    winning mask, n_lit, n_off)."""
    lens, n_lit, n_off, n_def = _concat_lengths(lit_len, off_len)
    costs = []
    cl_lens = []
    for mask in _MASK_ORDER:
        h = rle_histogram(lens, n_def, mask)
        cl = limited_lengths(mk_lengths(h), 7)
        costs.append(rle_bits(lens, n_def, cl, mask))
        cl_lens.append(cl)
    cost_m = jnp.stack(costs, axis=1)          # (B, 17)
    cl_m = jnp.stack(cl_lens, axis=1)          # (B, 17, 19)
    best = jnp.min(cost_m, axis=1)
    # later mask in _MASK_ORDER wins ties -> max index among minima
    midx = jnp.max(
        jnp.where(cost_m == best[:, None],
                  jnp.arange(len(_MASK_ORDER), dtype=jnp.int32)[None, :], -1),
        axis=1,
    )
    mask_arr = jnp.asarray(np.asarray(_MASK_ORDER, dtype=np.int32))
    cl_sel = jnp.take_along_axis(cl_m, midx[:, None, None], axis=1)[:, 0]
    return mask_arr[midx], cl_sel, n_lit, n_off


def dynamic_cost(lit_hist: jnp.ndarray, off_hist: jnp.ndarray) -> jnp.ndarray:
    """estimated_dynamic_cost_of_entropy, batched: MK lengths from the
    histograms, symbol cost + dynamic table cost (+3 block header bits).
    (B, 288), (B, 32) -> (B,) int32 bit costs."""
    B = lit_hist.shape[0]
    lit_len = mk_lengths(lit_hist)
    off_len = mk_lengths(off_hist)

    rev_len = jnp.asarray(np.asarray(REV_MATCHLEN_SYMBOL_BITS, dtype=np.int32))
    rev_off = jnp.asarray(np.asarray(REV_OFFSET_SYMBOL_BITS, dtype=np.int32))
    extra_lit = jnp.concatenate(
        [jnp.zeros(257, jnp.int32), rev_len, jnp.zeros(NLITERALSYMS - 257 - rev_len.shape[0], jnp.int32)]
    )
    # The reference's symbol-cost loops cover 0..256 and 257..285 only —
    # the two invalid literal symbols (286, 287) are excluded
    # (src/blockdeflate.c:577-581 loop bounds).
    lit_counted = jnp.where(
        jnp.arange(NLITERALSYMS)[None, :] < 257 + rev_len.shape[0], lit_hist, 0
    )
    cost = jnp.sum(lit_counted * (lit_len + extra_lit[None, :]), axis=1)
    cost = cost + jnp.sum(off_hist * (off_len + rev_off[None, :]), axis=1)

    n_lit = defined_count(lit_len, 257)
    n_off = defined_count(off_len, 1)
    # lens = concat(lit_len[:n_lit], off_len[:n_off]) as a fixed 320 array.
    L = NLITERALSYMS + NOFFSETSYMS
    j = jnp.arange(L, dtype=jnp.int32)[None, :]
    from_off = j >= n_lit[:, None]
    oidx = jnp.clip(j - n_lit[:, None], 0, NOFFSETSYMS - 1)
    lens = jnp.where(
        from_off,
        jnp.take_along_axis(off_len, oidx, axis=1),
        jnp.take_along_axis(lit_len, jnp.clip(j, 0, NLITERALSYMS - 1), axis=1),
    )
    n_def = n_lit + n_off

    te_hist = rle_histogram(lens, n_def, 7)
    te_len = mk_lengths(te_hist)
    cost = cost + 5 + 5 + 4
    cost = cost + 3 * raw_table_size(te_len)
    cost = cost + rle_bits(lens, n_def, te_len, 31)
    return cost + 3
