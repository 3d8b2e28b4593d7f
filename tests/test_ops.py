"""Device (JAX/XLA) stages: cross-validation against the spec and native
engines. Runs on the CPU (conftest: 8 virtual devices)."""

import zlib

import numpy as np
import pytest
from conftest import SOURCE_TEXT

from zultra_tpu.constants import NLITERALSYMS, NOFFSETSYMS


@pytest.mark.parametrize("seed", range(6))
def test_suffix_array_jax_matches_numpy(seed):
    from zultra_tpu.ops import suffix_array_jax
    from zultra_tpu.suffix import suffix_array_numpy

    rng = np.random.RandomState(seed)
    n = int(rng.randint(2, 2000))
    alphabet = int(rng.choice([2, 4, 256]))
    data = rng.randint(0, alphabet, n).astype(np.uint8)
    assert np.array_equal(suffix_array_jax(data), suffix_array_numpy(data))


@pytest.mark.parametrize("seed", range(4))
def test_plcp_jax_matches_numpy(seed):
    from zultra_tpu.ops import plcp_jax
    from zultra_tpu.suffix import plcp_numpy, suffix_array_numpy

    rng = np.random.RandomState(50 + seed)
    n = int(rng.randint(2, 1500))
    data = rng.randint(0, 4, n).astype(np.uint8)
    sa = suffix_array_numpy(data)
    assert np.array_equal(plcp_jax(data), plcp_numpy(data, sa))


def test_token_histogram_jax():
    from zultra_tpu.ops import token_histogram_jax

    rng = np.random.RandomState(7)
    syms = rng.randint(0, 288, 5000).astype(np.int32)
    hist = np.asarray(token_histogram_jax(syms, 288))
    assert np.array_equal(hist, np.bincount(syms, minlength=288))


def test_adler32_jax_and_combine():
    from zultra_tpu.ops import adler32_combine, adler32_jax

    rng = np.random.RandomState(9)
    data = rng.bytes(100000)
    assert adler32_jax(np.frombuffer(data, np.uint8)) == zlib.adler32(data)
    # associative shard combine
    a = zlib.adler32(data[:30000])
    b = zlib.adler32(data[30000:])
    assert adler32_combine(a, b, 70000) == zlib.adler32(data)


def test_crc32_combine():
    from zultra_tpu.ops import crc32_combine
    from zultra_tpu.ops.checksum import crc32_sharded

    rng = np.random.RandomState(10)
    data = rng.bytes(99991)
    a = zlib.crc32(data[:12345])
    b = zlib.crc32(data[12345:])
    assert crc32_combine(a, b, len(data) - 12345) == zlib.crc32(data)
    shards = [data[i : i + 10000] for i in range(0, len(data), 10000)]
    assert crc32_sharded(shards) == zlib.crc32(data)


def _random_match_table(rng, n):
    """Synthetic descending-length match tables with valid offsets."""
    table = np.zeros((n, 8, 2), dtype=np.int32)
    for i in range(1, n):
        k = int(rng.randint(0, 4))
        if k:
            lens = np.sort(rng.randint(3, 259, k))[::-1]
            lens = np.minimum(lens, n - i)
            for m in range(k):
                if lens[m] >= 3:
                    table[i, m, 0] = lens[m]
                    table[i, m, 1] = int(rng.randint(1, min(i, 32768) + 1))
    return table


@pytest.mark.parametrize("seed", range(5))
def test_dp_jax_matches_spec_and_native(seed):
    from zultra_tpu import native
    from zultra_tpu.huffman import HuffmanEncoder
    from zultra_tpu.ops import optimize_matches_jax
    from zultra_tpu.parse import optimize_matches

    rng = np.random.RandomState(200 + seed)
    n = int(rng.randint(300, 1200))
    window = rng.randint(0, 200, n).astype(np.uint8)
    table = _random_match_table(rng, n)

    lit = HuffmanEncoder(NLITERALSYMS, 15, 0)
    off = HuffmanEncoder(NOFFSETSYMS, 15, 0)
    lit.code_length = [int(x) for x in rng.randint(1, 16, 288)]
    off.code_length = [int(x) for x in rng.randint(1, 16, 32)]

    best_spec = np.zeros((n, 2), dtype=np.int32)
    optimize_matches(lit, off, window, table, best_spec, 0, n)

    best_native = native.optimize_matches(
        lit.code_length[:288], off.code_length[:32], window, table.astype(np.uint16), 0, n
    ).astype(np.int32)
    assert np.array_equal(best_spec, best_native)

    best_jax = optimize_matches_jax(
        lit.code_length[:288], off.code_length[:32], window, table, 0, n
    )
    assert np.array_equal(best_spec, best_jax)


def test_dp_block_boundary_unsigned_wrap():
    """A ≥40-length match clamped below MIN_MATCH_SIZE at a block boundary
    exercises the reference's unsigned-wrap path (index 255): all three
    DP implementations must agree."""
    from zultra_tpu import native
    from zultra_tpu.huffman import HuffmanEncoder
    from zultra_tpu.ops import optimize_matches_jax
    from zultra_tpu.parse import optimize_matches

    n = 100
    window = np.arange(n, dtype=np.uint8) % 7
    table = np.zeros((n, 8, 2), dtype=np.int32)
    # Long match near the very end of the block: length 50 at n-2.
    table[n - 2, 0] = (50, 7)
    table[n - 2, 1] = (4, 3)
    table[n - 10, 0] = (60, 5)

    lit = HuffmanEncoder(NLITERALSYMS, 15, 0)
    off = HuffmanEncoder(NOFFSETSYMS, 15, 0)
    # Make symbol 285 (index 255) artificially cheap so the wrapped
    # candidate can win if the semantics allow it.
    lit.code_length = [12] * 288
    lit.code_length[285] = 1
    off.code_length = [1] * 32

    best_spec = np.zeros((n, 2), dtype=np.int32)
    optimize_matches(lit, off, window, table, best_spec, 0, n)
    best_native = native.optimize_matches(
        lit.code_length[:288], off.code_length[:32], window, table.astype(np.uint16), 0, n
    ).astype(np.int32)
    best_jax = optimize_matches_jax(
        lit.code_length[:288], off.code_length[:32], window, table, 0, n
    )
    assert np.array_equal(best_spec, best_native)
    assert np.array_equal(best_spec, best_jax)


def brute_force_parse_cost(window, table, lit_lens, off_lens, cached=None):
    """Exponential-time optimal parse oracle on tiny inputs: minimum bit
    cost over every (literal | truncated-match) decomposition using the
    same candidate set and cost model as the DP."""
    from zultra_tpu.constants import (
        LEAVE_ALONE_MATCH_SIZE,
        MATCHLEN_EXTRA_BITS,
        MATCHLEN_SYMBOL,
        MIN_MATCH_SIZE,
        OFFSET_EXTRA_BITS,
        OFFSET_SYMBOL,
        offset_table_index,
    )

    n = len(window)
    INF = float("inf")
    memo = {}

    def varlen_size(enc_len):
        idx = enc_len if 0 <= enc_len <= 255 else 255
        return lit_lens[int(MATCHLEN_SYMBOL[idx])] + int(MATCHLEN_EXTRA_BITS[idx])

    def best(i):
        if i >= n:
            return 0
        if i in memo:
            return memo[i]
        cost = lit_lens[int(window[i])] + best(i + 1)
        for m in range(8):
            length = int(table[i, m, 0])
            if length < MIN_MATCH_SIZE:
                break
            offset = int(table[i, m, 1])
            t = offset_table_index(offset)
            osize = off_lens[int(OFFSET_SYMBOL[t])] + int(OFFSET_EXTRA_BITS[t])
            clamped = min(length, n - i)
            if length >= LEAVE_ALONE_MATCH_SIZE:
                ks = [clamped]
            else:
                ks = range(MIN_MATCH_SIZE, clamped + 1)
            for k in ks:
                c = varlen_size(k - MIN_MATCH_SIZE) + osize + best(i + k)
                cost = min(cost, c)
        memo[i] = cost
        return cost

    return best(0)


@pytest.mark.parametrize("seed", range(6))
def test_dp_cost_matches_brute_force(seed):
    """The DP's chosen parse must achieve the brute-force minimum cost."""
    from zultra_tpu.constants import MIN_MATCH_SIZE
    from zultra_tpu.huffman import HuffmanEncoder
    from zultra_tpu.parse import optimize_matches, get_offset_size, get_varlen_size

    rng = np.random.RandomState(400 + seed)
    n = int(rng.randint(12, 40))
    window = rng.randint(0, 5, n).astype(np.uint8)
    table = _random_match_table(rng, n)

    lit = HuffmanEncoder(288, 15, 0)
    off = HuffmanEncoder(32, 15, 0)
    lit.code_length = [int(x) for x in rng.randint(1, 16, 288)]
    off.code_length = [int(x) for x in rng.randint(1, 16, 32)]

    best = np.zeros((n, 2), dtype=np.int32)
    optimize_matches(lit, off, window, table, best, 0, n)

    # Walk the chosen parse and add up its cost.
    cost = 0
    i = 0
    while i < n:
        length = int(best[i, 0])
        if length >= MIN_MATCH_SIZE:
            cost += get_varlen_size(lit, length - MIN_MATCH_SIZE)
            cost += get_offset_size(off, int(best[i, 1]))
            i += length
        else:
            cost += lit.code_length[int(window[i])]
            i += 1

    oracle = brute_force_parse_cost(window, table, lit.code_length, off.code_length)
    assert cost == oracle


def test_suffix_array_jax_window_scale():
    """SA kernel at a realistic window scale (50 KB) against SA-IS."""
    from zultra_tpu import native
    from zultra_tpu.ops import suffix_array_jax

    rng = np.random.RandomState(99)
    data = rng.randint(0, 64, 50000).astype(np.uint8)
    assert np.array_equal(suffix_array_jax(data), native.suffix_array(data))


@pytest.mark.parametrize("seed", range(8))
def test_psv_nsv_jax_matches_stack_oracle(seed):
    from zultra_tpu.ops.nsv import psv_nsv_jax

    rng = np.random.RandomState(300 + seed)
    n = int(rng.randint(1, 800))
    a = rng.randint(0, int(rng.choice([4, 50, 100000])), n).astype(np.int32)

    # Sequential stack oracle
    psv_o = np.full(n, -1, np.int32)
    stack = []
    for i in range(n):
        while stack and a[stack[-1]] >= a[i]:
            stack.pop()
        if stack:
            psv_o[i] = stack[-1]
        stack.append(i)
    nsv_o = np.full(n, n, np.int32)
    stack = []
    for i in range(n - 1, -1, -1):
        while stack and a[stack[-1]] >= a[i]:
            stack.pop()
        if stack:
            nsv_o[i] = stack[-1]
        stack.append(i)

    psv, nsv = psv_nsv_jax(a)
    assert np.array_equal(psv, psv_o)
    assert np.array_equal(nsv, nsv_o)


def test_lcp_pairs_jax():
    from zultra_tpu.ops.nsv import lcp_pairs_jax

    rng = np.random.RandomState(9)
    n = 500
    data = rng.randint(0, 3, n).astype(np.uint8)
    i_pos = rng.randint(0, n, 200).astype(np.int32)
    j_pos = rng.randint(0, n, 200).astype(np.int32)
    got = lcp_pairs_jax(data, i_pos, j_pos)
    raw = bytes(data)
    for k in range(200):
        i, j = int(i_pos[k]), int(j_pos[k])
        l = 0
        while i + l < n and j + l < n and raw[i + l] == raw[j + l]:
            l += 1
        if i == j:
            l = n - i
        assert got[k] == l, (k, i, j, got[k], l)


@pytest.mark.parametrize("seed", range(4))
def test_range_max_below_jax(seed):
    from zultra_tpu.ops.nsv import range_max_below_jax

    rng = np.random.RandomState(500 + seed)
    n = int(rng.randint(1, 300))
    a = rng.randint(0, 500, n).astype(np.int32)
    q = 40
    lo = rng.randint(0, n, q)
    hi = np.minimum(lo + rng.randint(1, n + 1, q), n)
    th = rng.randint(0, 600, q)
    got = range_max_below_jax(a, lo, hi, th)
    for k in range(q):
        vals = [x for x in a[lo[k] : hi[k]] if x < th[k]]
        want = max(vals) if vals else -(2**30)
        assert got[k] == want


def test_match_table_jax_equals_walk():
    """The loop-free device staircase matchfinder reproduces the lazy
    interval walk's tables bit-for-bit (including history skip-warm and
    the degenerate-run fallback)."""
    import numpy as np

    from zultra_tpu.matchfinder import find_all_matches
    from zultra_tpu.ops.matchfinder_jax import match_table_jax

    rng = np.random.RandomState(11)
    for _ in range(6):
        n = int(rng.randint(50, 2000))
        alpha = int(rng.choice([2, 4, 16, 256]))
        data = rng.randint(0, alpha, n).astype(np.uint8)
        start = int(rng.choice([0, min(n // 3, 200)]))
        assert np.array_equal(
            find_all_matches(data.copy(), start, n), match_table_jax(data, start, n)
        ), (n, alpha, start)
    # Degenerate run → membership-budget overflow → host fallback path.
    z = np.zeros(6000, dtype=np.uint8)
    assert np.array_equal(find_all_matches(z.copy(), 0, 6000), match_table_jax(z, 0, 6000))


def test_wavefront_dp_equals_native():
    """The blocked-wavefront DP (tile fixpoint + order-exact selection)
    reproduces the reference DP bit-for-bit, including truncation and
    offset tie-breaks, end clamping, and the ≥LEAVE_ALONE single-length
    rule."""
    import numpy as np

    from zultra_tpu.constants import NLITERALSYMS, NOFFSETSYMS
    from zultra_tpu.native import build_match_table, optimize_matches as native_dp
    from zultra_tpu.ops.parse_wavefront import optimize_matches_wavefront

    rng = np.random.RandomState(21)
    for trial in range(4):
        n = int(rng.randint(200, 6000))
        alpha = int(rng.choice([4, 64, 256]))
        data = rng.randint(0, alpha, n).astype(np.uint8)
        table = build_match_table(data.copy(), 0).astype(np.int32)
        lit = rng.randint(1, 16, NLITERALSYMS).astype(np.int32)
        off = rng.randint(1, 16, NOFFSETSYMS).astype(np.int32)
        start = int(rng.choice([0, 128]))
        ref = native_dp(lit, off, data, table.astype(np.uint16), start, n).astype(np.int32)
        got = optimize_matches_wavefront(lit, off, data, table, start, n)
        assert np.array_equal(ref, got), (trial, n, alpha, start)


@pytest.mark.parametrize("seed", range(4))
def test_padded_descent_find_left_right(seed):
    """The single-descent PSV/NSV over the zero-padded sparse-min table
    (matchfinder_jax._find_left/_find_right) against a brute oracle, at
    the kernel's exact call shapes (L has 0-sentinels at both ends and
    thresholds are the values themselves, clamped to >= 1)."""
    import math

    import jax.numpy as jnp

    from zultra_tpu.ops.matchfinder_jax import (
        _build_sparse_min, _find_left, _find_right,
    )

    rng = np.random.RandomState(400 + seed)
    n = int(rng.randint(4, 700))
    inner = rng.randint(0, int(rng.choice([3, 8, 258])), max(n - 1, 0))
    L = np.zeros(n + 1, np.int32)
    L[1:n] = np.where(inner < 3, 0, inner)

    m = n + 1
    lev = max(1, int(math.ceil(math.log2(m))))
    pad = 1 << lev
    padded = jnp.concatenate(
        [jnp.zeros(pad, jnp.int32), jnp.asarray(L), jnp.zeros(pad, jnp.int32)]
    )
    st = _build_sparse_min(padded, lev)

    t_idx = np.arange(n, dtype=np.int32)
    v_t = L[:n]
    thresh = np.maximum(v_t, 1)
    a = np.asarray(_find_left(st, lev, pad, jnp.asarray(np.maximum(t_idx - 1, 0)),
                              jnp.asarray(thresh)))
    b = np.asarray(_find_right(st, lev, pad, jnp.asarray(t_idx + 1),
                               jnp.asarray(thresh)))

    for t in range(n):
        x = max(t - 1, 0)
        want_a = max(j for j in range(x + 1) if L[j] < thresh[t])
        assert a[t] == want_a, (t, a[t], want_a)
        want_b = min(j for j in range(t + 1, m) if L[j] < thresh[t])
        assert b[t] == want_b, (t, b[t], want_b)


def test_doubling_rounds_store_levels():
    """Capped rank-table storage: rows are the true per-level tables, the
    SA is the full suffix array, and equality at any stored level still
    answers 'equal 2^l-gram?' correctly (the staircase's LCP contract)."""
    import jax.numpy as jnp

    from zultra_tpu.ops.suffix_jax import _doubling_rounds, _num_levels
    from zultra_tpu.suffix import suffix_array_numpy

    rng = np.random.RandomState(7)
    data = rng.randint(0, 4, 3000).astype(np.uint8)
    n = data.shape[0]
    levels = _num_levels(n)

    sa_full, ranks_full = _doubling_rounds(jnp.asarray(data.astype(np.int32)), n, levels)
    sa_cap, ranks_cap = _doubling_rounds(
        jnp.asarray(data.astype(np.int32)), n, levels, store_levels=8
    )
    assert np.array_equal(np.asarray(sa_cap), suffix_array_numpy(data))
    assert np.array_equal(np.asarray(sa_cap), np.asarray(sa_full))
    assert ranks_cap.shape[0] == 9
    assert np.array_equal(np.asarray(ranks_cap), np.asarray(ranks_full[:9]))

    # Equality semantics per stored level: ranks equal <=> grams equal.
    ranks_np = np.asarray(ranks_cap)
    for l in (0, 3, 8):
        w = 1 << l
        pairs = np.random.RandomState(11).randint(0, n - w, (64, 2))
        for i, j in pairs:
            same = np.array_equal(data[i : i + w], data[j : j + w])
            assert (ranks_np[l][i] == ranks_np[l][j]) == same


def test_write_tokens_jax_equals_bitwriter():
    """Device token emission (pointer-doubling token walk + prefix-sum
    bit offsets + word scatter) is byte-identical to the sequential
    BitWriter writing the same tokens (reference write loop semantics,
    blockdeflate.c:471-507), including the EOD codeword."""
    from zultra_tpu import native
    from zultra_tpu.bitwriter import BitWriter
    from zultra_tpu.constants import (
        MATCHLEN_BASE, MATCHLEN_EXTRA_BITS, MATCHLEN_SYMBOL, MIN_MATCH_SIZE,
        NEODMARKERSYM, NLITERALSYMS, NOFFSETSYMS, OFFSET_BASE,
        OFFSET_EXTRA_BITS, OFFSET_SYMBOL,
        static_literal_code_lengths, static_offset_code_lengths,
    )
    from zultra_tpu.huffman import HuffmanEncoder
    from zultra_tpu.ops.emit_jax import write_tokens_jax

    lit = HuffmanEncoder(NLITERALSYMS, 15)
    off = HuffmanEncoder(NOFFSETSYMS, 15)
    lit.code_length[:NLITERALSYMS] = [int(x) for x in static_literal_code_lengths()]
    off.code_length[:NOFFSETSYMS] = [int(x) for x in static_offset_code_lengths()]
    lit.build_static_codewords()
    off.build_static_codewords()
    lit_lens = np.asarray(lit.code_length, dtype=np.int32)
    off_lens = np.asarray(off.code_length, dtype=np.int32)

    src = SOURCE_TEXT.read_bytes()
    rng = np.random.RandomState(5)
    cases = [
        (np.frombuffer(src[:20000], dtype=np.uint8), 0),
        (np.frombuffer(src[:9000], dtype=np.uint8), 4096),  # history prefix
        (rng.randint(0, 256, 5000).astype(np.uint8), 0),    # literal-heavy
        (np.tile(np.frombuffer(b"abcab", dtype=np.uint8), 1500), 0),  # match-heavy
    ]
    for data, start in cases:
        data = np.ascontiguousarray(data)
        n = data.shape[0]
        table = native.build_match_table(data, start)
        best = native.optimize_matches(
            lit_lens, off_lens, data, table, start, n
        ).astype(np.int32)

        got_bytes, got_bits = write_tokens_jax(data, best, start, n, lit, off)

        buf = bytearray(4 * n + 64)
        bw = BitWriter(buf, 0, len(buf))
        bits = 0
        i = start
        while i < n:
            length = int(best[i, 0])
            if length >= MIN_MATCH_SIZE:
                e = length - MIN_MATCH_SIZE
                eidx = min(e, 255)
                lit.write_codeword(int(MATCHLEN_SYMBOL[eidx]), bw)
                bw.put_bits(e - int(MATCHLEN_BASE[eidx]), int(MATCHLEN_EXTRA_BITS[eidx]))
                offset = int(best[i, 1])
                oidx = offset - 1 if offset <= 256 else 256 + ((offset - 1 - 256) >> 7)
                off.write_codeword(int(OFFSET_SYMBOL[oidx]), bw)
                bw.put_bits(offset - int(OFFSET_BASE[oidx]), int(OFFSET_EXTRA_BITS[oidx]))
                bits += lit.code_length[MATCHLEN_SYMBOL[eidx]] + int(MATCHLEN_EXTRA_BITS[eidx])
                bits += off.code_length[OFFSET_SYMBOL[oidx]] + int(OFFSET_EXTRA_BITS[oidx])
                i += length
            else:
                lit.write_codeword(int(data[i]), bw)
                bits += lit.code_length[data[i]]
                i += 1
        lit.write_codeword(NEODMARKERSYM, bw)
        bits += lit.code_length[NEODMARKERSYM]
        bw.flush_bits()

        assert got_bits == bits, (got_bits, bits)
        assert got_bytes == bytes(buf[: bw.get_offset()]), "bitstream mismatch"


def test_write_tokens_jax_dynamic_codes():
    """Device emission with DYNAMIC codewords (the production shape):
    codes built from the final token histogram, exactly as plan_block
    hands them to the write loop."""
    from zultra_tpu import native
    from zultra_tpu.bitwriter import BitWriter
    from zultra_tpu.constants import (
        MATCHLEN_BASE, MATCHLEN_EXTRA_BITS, MATCHLEN_SYMBOL, MIN_MATCH_SIZE,
        NEODMARKERSYM, NLITERALSYMS, NOFFSETSYMS, OFFSET_BASE,
        OFFSET_EXTRA_BITS, OFFSET_SYMBOL,
        static_literal_code_lengths, static_offset_code_lengths,
    )
    from zultra_tpu.huffman import HuffmanEncoder
    from zultra_tpu.ops.emit_jax import write_tokens_jax

    data = np.frombuffer(SOURCE_TEXT.read_bytes()[20000:36384], dtype=np.uint8)
    data = np.ascontiguousarray(data)
    n = data.shape[0]
    table = native.build_match_table(data, 0)

    # Pass 1 with static lengths to get tokens, then dynamic codes from
    # the token histogram (like the convergence loop's recount).
    slit = np.asarray(static_literal_code_lengths(), dtype=np.int32)
    slit = np.concatenate([slit, np.zeros(NLITERALSYMS - slit.shape[0], np.int32)])
    soff = np.asarray(static_offset_code_lengths(), dtype=np.int32)
    best = native.optimize_matches(slit[:NLITERALSYMS], soff, data, table, 0, n).astype(np.int32)

    lit = HuffmanEncoder(NLITERALSYMS, 15)
    off = HuffmanEncoder(NOFFSETSYMS, 15)
    i = 0
    while i < n:
        length = int(best[i, 0])
        if length >= MIN_MATCH_SIZE:
            e = min(length - MIN_MATCH_SIZE, 255)
            lit.entropy[int(MATCHLEN_SYMBOL[e])] += 1
            offset = int(best[i, 1])
            oidx = offset - 1 if offset <= 256 else 256 + ((offset - 1 - 256) >> 7)
            off.entropy[int(OFFSET_SYMBOL[oidx])] += 1
            i += length
        else:
            lit.entropy[int(data[i])] += 1
            i += 1
    lit.entropy[NEODMARKERSYM] += 1
    lit.build_dynamic_codewords()
    off.build_dynamic_codewords()

    got_bytes, got_bits = write_tokens_jax(data, best, 0, n, lit, off)

    buf = bytearray(4 * n + 64)
    bw = BitWriter(buf, 0, len(buf))
    i = 0
    bits = 0
    while i < n:
        length = int(best[i, 0])
        if length >= MIN_MATCH_SIZE:
            e = length - MIN_MATCH_SIZE
            eidx = min(e, 255)
            lit.write_codeword(int(MATCHLEN_SYMBOL[eidx]), bw)
            bw.put_bits(e - int(MATCHLEN_BASE[eidx]), int(MATCHLEN_EXTRA_BITS[eidx]))
            offset = int(best[i, 1])
            oidx = offset - 1 if offset <= 256 else 256 + ((offset - 1 - 256) >> 7)
            off.write_codeword(int(OFFSET_SYMBOL[oidx]), bw)
            bw.put_bits(offset - int(OFFSET_BASE[oidx]), int(OFFSET_EXTRA_BITS[oidx]))
            bits += lit.code_length[MATCHLEN_SYMBOL[eidx]] + int(MATCHLEN_EXTRA_BITS[eidx])
            bits += off.code_length[OFFSET_SYMBOL[oidx]] + int(OFFSET_EXTRA_BITS[oidx])
            i += length
        else:
            lit.write_codeword(int(data[i]), bw)
            bits += lit.code_length[data[i]]
            i += 1
    lit.write_codeword(NEODMARKERSYM, bw)
    bits += lit.code_length[NEODMARKERSYM]
    bw.flush_bits()

    assert got_bits == bits
    assert got_bytes == bytes(buf[: bw.get_offset()])


def test_mk_lengths_jax_equals_host():
    """Batched device MK code lengths (ops/entropy_jax.mk_lengths) vs the
    host HuffmanEncoder on randomized histograms across all three
    alphabets, including 0/1-used-symbol quirks and exponential weights."""
    import jax.numpy as jnp
    import numpy as np

    from zultra_tpu.huffman import HuffmanEncoder
    from zultra_tpu.ops.entropy_jax import mk_lengths

    rng = np.random.RandomState(77)
    for S in (19, 32, 288):
        hists = []
        for _ in range(12):
            n_used = int(rng.randint(0, S + 1))
            h = np.zeros(S, np.int32)
            if n_used:
                idxs = rng.choice(S, n_used, replace=False)
                style = rng.randint(3)
                if style == 0:
                    h[idxs] = rng.randint(1, 100, n_used)
                elif style == 1:
                    h[idxs] = rng.randint(1, 4, n_used)
                else:
                    h[idxs] = (2.0 ** rng.randint(0, 18, n_used)).astype(np.int64)
            hists.append(h)
        got = np.asarray(mk_lengths(jnp.asarray(np.stack(hists))))
        for h, row in zip(hists, got):
            enc = HuffmanEncoder(S, 15, 0)
            enc.entropy = [int(x) for x in h]
            enc.estimate_dynamic_codelens()
            assert np.array_equal(np.array(enc.code_length[:S]), row), h.tolist()


def test_dynamic_cost_jax_equals_host():
    """Device batched estimated-dynamic-cost (MK + CL-RLE accounting) vs
    the host _estimated_dynamic_cost_of_entropy."""
    import jax.numpy as jnp
    import numpy as np

    from zultra_tpu.blocks import (
        _estimated_dynamic_cost_of_entropy,
        make_block_encoders,
    )
    from zultra_tpu.constants import NLITERALSYMS, NOFFSETSYMS
    from zultra_tpu.ops.entropy_jax import dynamic_cost

    rng = np.random.RandomState(13)
    B = 24
    lits = np.zeros((B, NLITERALSYMS), np.int32)
    offs = np.zeros((B, NOFFSETSYMS), np.int32)
    refs = np.zeros(B, np.int64)
    for b in range(B):
        nl = int(rng.randint(1, 289))
        no = int(rng.randint(0, 33))
        lits[b, rng.choice(NLITERALSYMS, nl, replace=False)] = rng.randint(1, 1000, nl)
        if no:
            offs[b, rng.choice(NOFFSETSYMS, no, replace=False)] = rng.randint(1, 500, no)
        lit_e, off_e = make_block_encoders()
        lit_e.entropy = [int(x) for x in lits[b]]
        off_e.entropy = [int(x) for x in offs[b]]
        refs[b] = _estimated_dynamic_cost_of_entropy(lit_e, off_e)
    got = np.asarray(dynamic_cost(jnp.asarray(lits), jnp.asarray(offs)))
    assert np.array_equal(got.astype(np.int64), refs)


def test_block_split_jax_equals_host():
    """Device level-synchronous splitter vs the host recursive splitter:
    bit-identical split points on text, mixed-entropy (multi-split),
    LZ-heavy, and degenerate-run data, with and without history."""
    import numpy as np

    from zultra_tpu.blocks import block_split
    from zultra_tpu.constants import MAX_SPLITS
    from zultra_tpu.native import build_match_table
    from zultra_tpu.ops.split_jax import block_split_jax

    rng = np.random.RandomState(3)
    text = np.frombuffer(
        (b"the quick brown fox jumps over the lazy dog. " * 2000), np.uint8
    )[:40000].copy()
    rand = rng.randint(0, 256, 30000).astype(np.uint8)
    runs = np.repeat(rng.randint(0, 4, 8000).astype(np.uint8), 5)[:30000]
    cases = [
        text,
        np.concatenate([text[:30000], rand, runs]),  # forces splits
        np.zeros(40000, np.uint8),
        text[:6000],  # below the 8 KB minimum
    ]
    for ci, data in enumerate(cases):
        for prev in (0, 128):
            w = np.concatenate([np.zeros(prev, np.uint8), data]) if prev else data
            n = len(w)
            table = build_match_table(w.copy(), prev).astype(np.int32)
            ref = block_split(w, table, prev, n - prev, MAX_SPLITS)
            got = block_split_jax(w, table, prev, n - prev)
            assert ref == got, (ci, prev, ref[:8], got[:8])


def test_scan_dp_batch_equals_native():
    """The batched scan-DP (cost scan + order-exact selection) matches the
    native DP bit-for-bit on mixed-size blocks."""
    import numpy as np

    from zultra_tpu.blocks import prepare_cost_evaluation
    from zultra_tpu.native import build_match_table, optimize_matches as native_dp
    from zultra_tpu.ops.parse_wavefront import optimize_matches_wavefront_batch

    rng = np.random.RandomState(17)
    jobs, refs = [], []
    for b in range(4):
        n = int(rng.randint(300, 6000))
        alpha = int(rng.choice([4, 64, 256]))
        data = rng.randint(0, alpha, n).astype(np.uint8)
        table = build_match_table(data.copy(), 0).astype(np.int32)
        lit_e, off_e = prepare_cost_evaluation(data, table, 0, n)
        lit_e.estimate_dynamic_codelens()
        off_e.estimate_dynamic_codelens()
        lit = np.asarray(lit_e.code_length, np.int32)
        lit[lit == 0] = 9
        off = np.asarray(off_e.code_length, np.int32)
        off[off == 0] = 6
        jobs.append((lit, off, data, table, 0, n))
        refs.append(native_dp(lit, off, data, table.astype(np.uint16), 0, n).astype(np.int32))
    outs = optimize_matches_wavefront_batch(jobs, method="scan")
    for o, r in zip(outs, refs):
        assert np.array_equal(o, r)


def _random_hists(rng, S, n_lanes, force_deep=False):
    hists = []
    for lane in range(n_lanes):
        h = np.zeros(S, np.int64)
        if force_deep and lane % 3 == 0:
            # Fibonacci-ish counts force unlimited MK depths > 15 so the
            # Kraft repair path actually runs.
            k = int(rng.randint(min(12, S - 1), min(40, S)))
            a, b = 1, 1
            idxs = rng.choice(S, k, replace=False)
            for i in idxs:
                h[i] = a
                a, b = b, a + b
        else:
            n_used = int(rng.randint(0, S + 1))
            if n_used:
                idxs = rng.choice(S, n_used, replace=False)
                style = rng.randint(3)
                if style == 0:
                    h[idxs] = rng.randint(1, 100, n_used)
                elif style == 1:
                    h[idxs] = rng.randint(1, 4, n_used)
                else:
                    h[idxs] = (2.0 ** rng.randint(0, 16, n_used)).astype(np.int64)
        hists.append(h.astype(np.int32))
    return hists


def test_limited_lengths_and_codewords_equal_host():
    """Device Kraft-limited lengths + canonical codewords vs
    HuffmanEncoder.build_dynamic_codewords across alphabets, including
    lanes whose unlimited MK depth exceeds the limit (repair path)."""
    import jax.numpy as jnp

    from zultra_tpu.huffman import HuffmanEncoder
    from zultra_tpu.ops.entropy_jax import (
        build_lengths,
        canonical_codewords,
        mk_lengths,
    )

    rng = np.random.RandomState(101)
    for S, max_len in ((19, 7), (32, 15), (288, 15)):
        hists = _random_hists(rng, S, 18, force_deep=True)
        H = jnp.asarray(np.stack(hists))
        lens = np.asarray(build_lengths(H, max_len))
        cws = np.asarray(canonical_codewords(jnp.asarray(lens)))
        # sanity: at least one lane hit the repair path
        assert np.any(np.asarray(mk_lengths(H)) > max_len), (S, max_len)
        for h, lrow, crow in zip(hists, lens, cws):
            enc = HuffmanEncoder(S, max_len, 0)
            enc.entropy = [int(x) for x in h]
            enc.build_dynamic_codewords()
            assert np.array_equal(np.array(enc.code_length[:S]), lrow), h.tolist()
            exp_cw = np.array(enc.code_word[:S])
            exp_cw[np.array(enc.code_length[:S]) == 0] = 0
            got_cw = crow.copy()
            assert np.array_equal(exp_cw, got_cw), h.tolist()


def test_optimize_for_rle_jax_equals_host():
    """Device Zopfli histogram rewrite vs the host reference, including
    all-zero, trailing-zero, and long-run shapes."""
    import jax.numpy as jnp

    from zultra_tpu.huffman import optimize_histogram_for_rle
    from zultra_tpu.ops.entropy_jax import optimize_for_rle_jax

    rng = np.random.RandomState(55)
    for S in (32, 288):
        lanes = []
        for t in range(24):
            h = np.zeros(S, np.int64)
            style = t % 4
            if style == 0:
                k = rng.randint(1, S)
                h[:k] = rng.randint(0, 50, k)
            elif style == 1:
                # plateaus of similar values -> collapse path
                v = rng.randint(1, 30)
                k = rng.randint(8, S)
                h[:k] = v + rng.randint(-3, 4, k)
                h = np.maximum(h, 0)
            elif style == 2:
                # exact runs (good_for_rle path)
                i = 0
                while i < S:
                    run = rng.randint(1, 12)
                    h[i : i + run] = rng.randint(0, 6)
                    i += run
            # style 3: all zeros
            lanes.append(h.astype(np.int32))
        got = np.asarray(optimize_for_rle_jax(jnp.asarray(np.stack(lanes))))
        for h, row in zip(lanes, got):
            exp = [int(x) for x in h]
            optimize_histogram_for_rle(S, exp)
            assert np.array_equal(np.array(exp), row), h.tolist()


def test_static_cost_and_given_cost_equal_host():
    """Device static cost and given-lengths dynamic cost vs blocks.py."""
    import jax.numpy as jnp

    from zultra_tpu.blocks import (
        evaluate_dynamic_cost,
        evaluate_static_cost,
        make_block_encoders,
    )
    from zultra_tpu.constants import NLITERALSYMS, NOFFSETSYMS
    from zultra_tpu.ops.entropy_jax import dynamic_cost_given, static_cost

    rng = np.random.RandomState(9)
    lit_h = np.stack(_random_hists(rng, NLITERALSYMS, 10))
    off_h = np.stack(_random_hists(rng, NOFFSETSYMS, 10))
    lit_h[:, 256] = np.maximum(lit_h[:, 256], 1)  # EOD always present
    got_static = np.asarray(static_cost(jnp.asarray(lit_h), jnp.asarray(off_h)))

    lit_lens, off_lens, exp_static, exp_dyn = [], [], [], []
    for b in range(10):
        le, oe = make_block_encoders()
        le.entropy = [int(x) for x in lit_h[b]]
        oe.entropy = [int(x) for x in off_h[b]]
        exp_static.append(evaluate_static_cost(le, oe))
        le.build_dynamic_codewords()
        oe.build_dynamic_codewords()
        exp_dyn.append(evaluate_dynamic_cost(le, oe))
        lit_lens.append(np.array(le.code_length[:NLITERALSYMS], np.int32))
        off_lens.append(np.array(oe.code_length[:NOFFSETSYMS], np.int32))
    assert np.array_equal(got_static, np.array(exp_static))

    got_dyn = np.asarray(
        dynamic_cost_given(
            jnp.asarray(lit_h), jnp.asarray(off_h),
            jnp.asarray(np.stack(lit_lens)), jnp.asarray(np.stack(off_lens)),
        )
    )
    assert np.array_equal(got_dyn, np.array(exp_dyn))


def test_mask_search_jax_equals_host():
    """Device CL-mask search (17 masks, later wins ties) vs the host loop
    in blocks.block_deflate."""
    import jax.numpy as jnp

    from zultra_tpu.constants import MAX_CODES_MASK, NCODELENSYMS, NLITERALSYMS, NOFFSETSYMS
    from zultra_tpu.huffman import (
        get_var_lengths_size,
        make_tables_encoder,
        update_var_lengths_entropy,
    )
    from zultra_tpu.huffman import HuffmanEncoder
    from zultra_tpu.ops.entropy_jax import mask_search

    rng = np.random.RandomState(23)
    lit_lens, off_lens = [], []
    for b in range(8):
        le = HuffmanEncoder(NLITERALSYMS, 15, 0)
        oe = HuffmanEncoder(NOFFSETSYMS, 15, 0)
        le.entropy = [int(x) for x in _random_hists(rng, NLITERALSYMS, 1)[0]]
        oe.entropy = [int(x) for x in _random_hists(rng, NOFFSETSYMS, 1)[0]]
        le.entropy[256] = max(le.entropy[256], 1)
        le.build_dynamic_codewords()
        oe.build_dynamic_codewords()
        lit_lens.append(np.array(le.code_length[:NLITERALSYMS], np.int32))
        off_lens.append(np.array(oe.code_length[:NOFFSETSYMS], np.int32))
    got_mask, got_cl, got_nlit, got_noff = mask_search(
        jnp.asarray(np.stack(lit_lens)), jnp.asarray(np.stack(off_lens))
    )
    got_mask, got_cl = np.asarray(got_mask), np.asarray(got_cl)
    got_nlit, got_noff = np.asarray(got_nlit), np.asarray(got_noff)

    for b in range(8):
        le_len, oe_len = lit_lens[b], off_lens[b]
        n_lit = NLITERALSYMS
        while n_lit > 257 and le_len[n_lit - 1] == 0:
            n_lit -= 1
        n_off = NOFFSETSYMS
        while n_off > 1 and oe_len[n_off - 1] == 0:
            n_off -= 1
        code_lengths = [int(x) for x in le_len[:n_lit]] + [int(x) for x in oe_len[:n_off]]
        te = make_tables_encoder()
        best_cost, best_mask = 0, -1
        mask = 0
        while mask <= MAX_CODES_MASK:
            update_var_lengths_entropy(te, n_lit + n_off, code_lengths, mask)
            te.build_dynamic_codewords()
            cur = get_var_lengths_size(te, n_lit + n_off, code_lengths, mask)
            if best_mask == -1 or best_cost >= cur:
                best_mask, best_cost = mask, cur
            for i in range(NCODELENSYMS):
                te.entropy[i] = 0
            mask = mask + 2 if mask >= 7 else mask + 1
        update_var_lengths_entropy(te, n_lit + n_off, code_lengths, best_mask)
        te.build_dynamic_codewords()
        assert got_nlit[b] == n_lit and got_noff[b] == n_off
        assert got_mask[b] == best_mask, (b, got_mask[b], best_mask)
        assert np.array_equal(got_cl[b], np.array(te.code_length[:NCODELENSYMS])), b


def test_symbol_map_closed_forms_match_tables():
    """The VPU closed forms equal the generated RFC tables for EVERY
    index (lengths 0..255; offset indices 0..509 — 510/511 are
    unreachable under the masks every caller applies)."""
    import jax.numpy as jnp
    import numpy as np

    from zultra_tpu.constants import (
        MATCHLEN_BASE,
        MATCHLEN_EXTRA_BITS,
        MATCHLEN_SYMBOL,
        OFFSET_BASE,
        OFFSET_EXTRA_BITS,
        OFFSET_SYMBOL,
    )
    from zultra_tpu.ops.symbol_map import (
        matchlen_sym_extra_base,
        offset_sym_extra_base,
    )

    e = jnp.arange(256, dtype=jnp.int32)
    sym, extra, base = matchlen_sym_extra_base(e)
    assert np.array_equal(np.asarray(sym), np.asarray(MATCHLEN_SYMBOL))
    assert np.array_equal(np.asarray(extra), np.asarray(MATCHLEN_EXTRA_BITS))
    assert np.array_equal(np.asarray(base), np.asarray(MATCHLEN_BASE))

    oidx = jnp.arange(510, dtype=jnp.int32)
    sym, extra, base = offset_sym_extra_base(oidx)
    assert np.array_equal(np.asarray(sym), np.asarray(OFFSET_SYMBOL)[:510])
    assert np.array_equal(np.asarray(extra), np.asarray(OFFSET_EXTRA_BITS)[:510])
    assert np.array_equal(np.asarray(base), np.asarray(OFFSET_BASE)[:510])


def test_split_jax_trigger_overflow_fallback():
    """Adversarial drift data (disjoint bucket sets alternating every
    512 bytes, all-literal) floods the per-level trigger count past the
    compact capacity K_CAP — the full-evaluation fallback must produce
    the same split points as the host splitter."""
    import numpy as np

    from zultra_tpu.blocks import block_split
    from zultra_tpu.native import build_match_table
    from zultra_tpu.ops.split_jax import block_split_jax

    rng = np.random.RandomState(7)
    parts = []
    for i in range(64):  # 32 KiB window of alternating 512-byte regimes
        lo, hi = (0x00, 0x10) if i % 2 == 0 else (0xF0, 0x100)
        parts.append(rng.randint(lo, hi, 512).astype(np.uint8))
    window = np.concatenate(parts)
    n = len(window)
    table = build_match_table(window.copy(), 0).astype(np.int32)

    expect = block_split(window, table, 0, n, 64)
    got = block_split_jax(window, table, 0, n)
    assert got == expect
