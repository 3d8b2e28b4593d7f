"""Device block planner: the complete per-block deflate decision flow —
greedy entropy, static/dynamic choice, the 3+1-pass parse/entropy/code
convergence loop, match→literal post-optimization, the Zopfli RLE A/B
test, the CL-mask search, and token emission — as ONE batched jit over
independent blocks.

Replaces the semantics of the reference's block driver
(reference src/blockdeflate.c:827-997 + the stream-level cost choice
src/libzultra.c:317-324; host ports: blocks.block_deflate,
stream.Stream._compress_window) with a data-parallel formulation:

* Token walks (greedy entropy, final entropy, emission order) resolve by
  pointer doubling — the greedy hop structure is memoryless, so block
  starts lie on the window-global chain and every walk is a subpath.
* The cost DP is the CUDA kernel of ops/dp_cuda on the GPU, and
  elsewhere the batched backward scan of ops/parse_wavefront with the
  order-exact selection pass; both make the same choices.
* All entropy decisions run through the batched device Huffman bundle
  (ops/entropy_jax): MK + Kraft-limited lengths, canonical codewords,
  Zopfli rewrite, mask search.
* Static vs dynamic lanes share one program: static lanes force the RFC
  1951 fixed lengths into every convergence pass (the DP is then
  idempotent across passes, which is exactly the host's single static
  parse), and the per-lane flag selects the emitted codewords.
* post_optimize's sequential walk has a closed form: a chosen match
  demotes to literals iff its span's summed literal cost is below the
  match cost AND the span contains no zero-length literal (the host's
  early-exit scan can only keep the match in those cases); demoted spans
  never overlap, so one cummax marks every covered position.

Outputs per block: the packed token words at bit phase 0 (emit_jax
construction), total bit count, the final code lengths, histogram-derived
table counts, and the winning CL mask — everything the host needs to
write HLIT/HDIST/HCLEN + tables (a few hundred bits) and splice the
token words at the stream's bit phase. Only ~compressed-size bytes cross
the device→host link.

Exactness: bit-identical plans and token streams vs blocks.block_deflate
on the fuzz corpus (tests/test_ops.py)."""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..constants import (
    LEAVE_ALONE_MATCH_SIZE,
    MAX_OFFSET,
    MIN_MATCH_SIZE,
    MIN_OFFSET,
    NEODMARKERSYM,
    NLITERALSYMS,
    NMATCHES_PER_OFFSET,
    NOFFSETSYMS,
    static_literal_code_lengths,
    static_offset_code_lengths,
)
from ..device import on_gpu
from .entropy_jax import (
    build_lengths,
    canonical_codewords,
    dynamic_cost,
    dynamic_cost_given,
    mask_search,
    optimize_for_rle_jax,
    static_cost,
)
from .parse_wavefront import (
    TILE,
    _dp_scan_cost,
    _osmin_k,
    _prep,
    _select_pass,
)
from .symbol_map import (
    matchlen_sym_extra_base,
    offset_sym_extra_base,
    select_by_symbol,
)

CONVERGENCE_PASSES = 3


def _static_tables():
    """Host-precomputed RFC 1951 fixed tables (lengths + bit-reversed
    codewords) — constants, so they never touch the device Huffman path."""
    from ..huffman import HuffmanEncoder

    lit = HuffmanEncoder(NLITERALSYMS, 15, 0)
    lit.code_length[:NLITERALSYMS] = [int(x) for x in static_literal_code_lengths()]
    lit.build_static_codewords()
    off = HuffmanEncoder(NOFFSETSYMS, 15, 0)
    off.code_length[:NOFFSETSYMS] = [int(x) for x in static_offset_code_lengths()]
    off.build_static_codewords()
    return (
        np.array(lit.code_length[:NLITERALSYMS], np.int32),
        np.array(lit.code_word[:NLITERALSYMS], np.int32),
        np.array(off.code_length[:NOFFSETSYMS], np.int32),
        np.array(off.code_word[:NOFFSETSYMS], np.int32),
    )


_STATIC_LIT_LEN, _STATIC_LIT_CW, _STATIC_OFF_LEN, _STATIC_OFF_CW = _static_tables()


def _chain_mask(step: jnp.ndarray, length: jnp.ndarray, n: int) -> jnp.ndarray:
    """Batched token-start mask for the hop structure next(i) = i +
    step[i], walked from position 0 while i < length. (B, n) bool."""
    B = step.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)[None, :]
    nxt = jnp.minimum(idx + step, n)
    jmp = jnp.concatenate([nxt, jnp.full((B, 1), n, jnp.int32)], axis=1)
    mark = jnp.zeros((B, n + 1), jnp.int32).at[:, 0].set(1)
    lane = jnp.arange(B)[:, None]
    rounds = max(1, int(math.ceil(math.log2(n + 1))) + 1)
    for _ in range(rounds):
        mark = jnp.maximum(
            mark, jnp.zeros((B, n + 1), jnp.int32).at[lane, jmp].max(mark, mode="drop")
        )
        jmp = jnp.take_along_axis(jmp, jmp, axis=1)
    return (mark[:, :n] == 1) & (idx < length[:, None])


def _token_hist(window, lens, offs, length, n: int, is_tok=None):
    """Batched greedy/final token entropy — accumulate_token_entropy
    (parse.py:143-172): walk the (lens, offs) hop structure from 0,
    histogram literal/length and offset symbols, EOD += 1. Matches
    crossing ``length`` count in full. Returns (lit_hist, off_hist,
    is_tok) so callers can reuse the (expensive, 17-round) chain walk
    when the hop structure is unchanged."""
    B = window.shape[0]
    is_match = lens >= MIN_MATCH_SIZE
    step = jnp.where(is_match, lens, 1)
    if is_tok is None:
        is_tok = _chain_mask(step, length, n)

    e = jnp.clip(lens - MIN_MATCH_SIZE, 0, 255)
    raw_off = jnp.maximum(offs - 1, 0)
    oidx = jnp.where(raw_off < 256, raw_off, 256 + ((raw_off - 256) >> 7))
    oidx = jnp.clip(oidx, 0, 511)
    len_sym_e, _, _ = matchlen_sym_extra_base(e)
    off_sym_o, _, _ = offset_sym_extra_base(oidx)
    sym1 = jnp.where(is_match, len_sym_e, window.astype(jnp.int32))
    sym2 = jnp.where(is_match & is_tok, off_sym_o, NOFFSETSYMS)

    lane = jnp.arange(B)[:, None]
    lit_hist = jnp.zeros((B, NLITERALSYMS + 1), jnp.int32).at[
        lane, jnp.where(is_tok, sym1, NLITERALSYMS)
    ].add(1)[:, :NLITERALSYMS]
    lit_hist = lit_hist.at[:, NEODMARKERSYM].add(1)
    off_hist = jnp.zeros((B, NOFFSETSYMS + 1), jnp.int32).at[
        lane, sym2
    ].add(1)[:, :NOFFSETSYMS]
    return lit_hist, off_hist, is_tok


def _run_dp(lit_lens, off_lens, window, mlens, moffs, length, n_pad: int):
    """One batched DP pass: the CUDA kernel (ops/dp_cuda) on the GPU,
    elsewhere the XLA backward scan + order-exact selection. The two
    give identical choices."""
    if on_gpu():
        from .dp_cuda import run_dp_cuda

        return run_dp_cuda(
            lit_lens, off_lens, window, mlens, moffs, length, n_pad
        )
    return run_dp_scan(lit_lens, off_lens, window, mlens, moffs, length, n_pad)


def run_dp_scan(lit_lens, off_lens, window, mlens, moffs, length, n_pad: int):
    """The DP as the XLA backward scan + order-exact selection, vmapped
    over the lanes: the CPU path and the reference for the CUDA kernel."""

    def one(ll, ol, w, ml, mo, ln):
        (
            in_block, lit_cost, clamped, osize, long_cost_static, long_step,
            short_clamped, run_min, n_long, ks, varlen_k,
        ) = _prep(ll, ol, w, ml, mo, ln, n_pad)
        osmin = _osmin_k(short_clamped, run_min, n_long, ks)
        cost = _dp_scan_cost(
            lit_cost, osmin, long_cost_static, long_step, ln, varlen_k, n_pad
        )
        cost_ext = jnp.concatenate([cost, jnp.zeros(TILE + 260, jnp.int32)])
        return _select_pass(
            cost_ext, lit_cost, ml, mo, osize, clamped, long_cost_static,
            long_step, in_block, ks, varlen_k, n_pad,
        )

    return jax.vmap(one)(lit_lens, off_lens, window, mlens, moffs, length)


def _offset_workaround(off_hist):
    """Always emit ≥2 offset codewords (zlib <1.2.1.1 inflate bug,
    reference src/blockdeflate.c:893-913), batched. Counts nonzero
    entries among symbols 0..NOFFSETSYMS-3."""
    counted = off_hist[:, : NOFFSETSYMS - 2]
    n = jnp.minimum(jnp.sum((counted > 0).astype(jnp.int32), axis=1), 2)
    e0, e1 = off_hist[:, 0], off_hist[:, 1]
    new0 = jnp.where((n == 0) | ((n == 1) & (e0 == 0)), 1, e0)
    new1 = jnp.where((n == 0) | ((n == 1) & (e0 > 0)), 1, e1)
    return off_hist.at[:, 0].set(new0).at[:, 1].set(new1)


def _post_optimize_full(best_len, best_off, window, lit_len_tbl, off_len_tbl,
                        length, n: int, is_tok):
    """Batched match→literal demotion — post_optimize (parse.py:175-216).
    A match demotes iff its span's literal cost sum is below the match
    cost and the span holds no zero-length literal (the host's early-exit
    scan can only keep the match in those cases); chosen spans are
    disjoint tokens, so covered positions resolve with one cummax.
    ``is_tok`` is the (best_len, best_off) chain's token mask (reused
    from the final convergence pass — same hop structure). Returns
    (demoted best_len, covered mask): after demotion the chain visits
    every covered position as a literal, so the emission token mask is
    ``is_tok | covered`` with no new walk."""
    B = window.shape[0]
    pos = jnp.arange(n, dtype=jnp.int32)[None, :]

    is_match = best_len >= MIN_MATCH_SIZE
    tok_match = is_tok & is_match & (best_off >= MIN_OFFSET) & (best_off <= MAX_OFFSET)

    lit_costs = jnp.take_along_axis(
        lit_len_tbl, window.astype(jnp.int32), axis=1
    )
    P = jnp.concatenate(
        [jnp.zeros((B, 1), jnp.int32), jnp.cumsum(lit_costs, axis=1)], axis=1
    )
    Z = jnp.concatenate(
        [jnp.zeros((B, 1), jnp.int32),
         jnp.cumsum((lit_costs == 0).astype(jnp.int32), axis=1)], axis=1
    )

    e = jnp.clip(best_len - MIN_MATCH_SIZE, 0, 255)
    raw_off = jnp.maximum(best_off - 1, 0)
    oidx = jnp.where(raw_off < 256, raw_off, 256 + ((raw_off - 256) >> 7))
    oidx = jnp.clip(oidx, 0, 511)
    ls, le, _ = matchlen_sym_extra_base(e)
    osym, oe, _ = offset_sym_extra_base(oidx)
    match_cost = (
        select_by_symbol(lit_len_tbl, ls, 257, 286, 0) + le
        + select_by_symbol(off_len_tbl, osym, 0, 30, 0) + oe
    )

    span_end = jnp.minimum(pos + best_len, n)
    span_cost = jnp.take_along_axis(P, span_end, axis=1) - jnp.take_along_axis(P, pos, axis=1)
    span_zero = jnp.take_along_axis(Z, span_end, axis=1) - jnp.take_along_axis(Z, pos, axis=1)
    demote = tok_match & (span_cost < match_cost) & (span_zero == 0)

    dem_end = lax.cummax(jnp.where(demote, span_end, 0), axis=1)
    covered = pos < dem_end
    return jnp.where(covered, 0, best_len), covered


def _emit_tokens(window, best_len, best_off, lit_cw, lit_len, off_cw, off_len,
                 length, n: int, is_tok=None):
    """Batched token emission at bit phase 0 — the emit_jax construction
    with a traced per-lane block length. ``is_tok`` (optional) reuses a
    precomputed token mask for (best_len, best_off)'s hop structure.
    Returns (words (B, W) uint32, total_bits (B,))."""
    B = window.shape[0]
    lane = jnp.arange(B)[:, None]

    is_m = best_len >= MIN_MATCH_SIZE
    if is_tok is None:
        step = jnp.where(is_m, best_len, 1)
        is_tok = _chain_mask(step, length, n)
    is_match = is_tok & is_m

    e = jnp.clip(best_len - MIN_MATCH_SIZE, 0, 255)
    raw_off = jnp.maximum(best_off - 1, 0)
    oidx = jnp.where(raw_off < 256, raw_off, 256 + ((raw_off - 256) >> 7))
    oidx = jnp.clip(oidx, 0, 511)
    ls, len_extra_e, len_base_e = matchlen_sym_extra_base(e)
    osym, off_extra_o, off_base_o = offset_sym_extra_base(oidx)

    byte = window.astype(jnp.int32)
    lit_v = jnp.take_along_axis(lit_cw, byte, axis=1)
    lit_n = jnp.take_along_axis(lit_len, byte, axis=1)
    m1_v = select_by_symbol(lit_cw, ls, 257, 286, 0) | (
        (e - len_base_e) << select_by_symbol(lit_len, ls, 257, 286, 0)
    )
    m1_n = select_by_symbol(lit_len, ls, 257, 286, 0) + len_extra_e
    m2_v = select_by_symbol(off_cw, osym, 0, 30, 0) | (
        (best_off - off_base_o) << select_by_symbol(off_len, osym, 0, 30, 0)
    )
    m2_n = select_by_symbol(off_len, osym, 0, 30, 0) + off_extra_o

    lane1_v = jnp.where(is_match, m1_v, jnp.where(is_tok, lit_v, 0))
    lane1_n = jnp.where(is_match, m1_n, jnp.where(is_tok, lit_n, 0))
    lane2_v = jnp.where(is_match, m2_v, 0)
    lane2_n = jnp.where(is_match, m2_n, 0)

    vals = jnp.stack([lane1_v, lane2_v], axis=2).reshape(B, -1)
    nbits = jnp.stack([lane1_n, lane2_n], axis=2).reshape(B, -1)
    eod_v = lit_cw[:, NEODMARKERSYM][:, None]
    eod_n = lit_len[:, NEODMARKERSYM][:, None]
    vals = jnp.concatenate([vals, eod_v], axis=1)
    nbits = jnp.concatenate([nbits, eod_n], axis=1)

    offs_bits = jnp.cumsum(nbits, axis=1) - nbits
    total_bits = offs_bits[:, -1] + nbits[:, -1]

    num_words = (16 * n + 64) // 32 + 2
    v = vals.astype(jnp.uint32)
    w = (offs_bits >> 5).astype(jnp.int32)
    sh = (offs_bits & 31).astype(jnp.uint32)
    lo = jnp.where(nbits > 0, (v << sh) & jnp.uint32(0xFFFFFFFF), jnp.uint32(0))
    hi = jnp.where((nbits > 0) & (sh > 0), v >> (jnp.uint32(32) - sh), jnp.uint32(0))
    words = jnp.zeros((B, num_words), jnp.uint32)
    words = words.at[lane, w].add(lo, mode="drop")
    words = words.at[lane, w + 1].add(hi, mode="drop")
    return words, total_bits


@functools.partial(jax.jit, static_argnames=("n_pad",))
def _plan_block_core(window, mlens, moffs, length, n_pad: int,
                     greedy_tok=None):
    """The per-block planning program up to the final histograms and
    lengths (no table search, no token emission), batched over
    B independent blocks padded to n_pad. All inputs are block-local
    (position 0 = block start); matches may reference bytes before the
    block via offsets only. ``greedy_tok`` (optional, (B, n_pad) bool)
    is the row-0 greedy token mask sliced from the splitter's
    window-global chain — block starts are chain tokens and the hop
    structure is memoryless, so the subpath equals the block-local walk
    and the greedy histogram skips its 17-round pointer-doubling walk.

    Returns the static/dynamic flags, the final histograms and lengths,
    the chosen matches and the emission token mask."""
    B = window.shape[0]
    static_lit_len = jnp.asarray(_STATIC_LIT_LEN)
    static_off_len = jnp.asarray(_STATIC_OFF_LEN)

    # Greedy entropy over match-table row 0 → static/dynamic choice.
    if greedy_tok is not None:
        greedy_tok = greedy_tok & (
            jnp.arange(n_pad, dtype=jnp.int32)[None, :] < length[:, None]
        )
    g_lit, g_off, _ = _token_hist(
        window, mlens[:, :, 0], moffs[:, :, 0], length, n_pad, greedy_tok
    )
    st_cost = static_cost(g_lit, g_off)
    dy_cost = dynamic_cost(g_lit, g_off)
    is_dyn = st_cost > dy_cost  # not (static <= dynamic)

    # Initial dynamic code lengths from the greedy entropy.
    lit_len = build_lengths(g_lit, 15)
    off_len = build_lengths(g_off, 15)

    # 3+1 convergence passes as ONE fori_loop body (a Python-unrolled
    # loop would quadruple the compiled DP subgraph — ~4x compile time).
    # The final pass's token mask rides the carry so post-optimize and
    # emission never re-walk the chain.
    def conv_pass(p, state):
        lit_len, off_len, best_len, best_off, f_lit, f_off, _ = state
        ll = jnp.where(is_dyn[:, None], lit_len, static_lit_len[None, :])
        ol = jnp.where(is_dyn[:, None], off_len, static_off_len[None, :])
        # Unused codewords get a default cost so the optimizer may adopt
        # them (static tables have no zeros, so this is dynamic-only).
        ll = jnp.where(ll == 0, 9, ll)
        ol = jnp.where(ol == 0, 6, ol)
        best_len, best_off = _run_dp(ll, ol, window, mlens, moffs, length, n_pad)
        f_lit, f_off, is_tok = _token_hist(window, best_len, best_off, length, n_pad)
        f_off = lax.cond(
            p == CONVERGENCE_PASSES, _offset_workaround, lambda h: h, f_off
        )
        lit_len = build_lengths(f_lit, 15)
        off_len = build_lengths(f_off, 15)
        return lit_len, off_len, best_len, best_off, f_lit, f_off, is_tok

    state0 = (
        lit_len, off_len,
        jnp.zeros((B, n_pad), jnp.int32), jnp.zeros((B, n_pad), jnp.int32),
        g_lit, g_off, jnp.zeros((B, n_pad), jnp.bool_),
    )
    lit_len, off_len, best_len, best_off, f_lit, f_off, is_tok = lax.fori_loop(
        0, CONVERGENCE_PASSES + 1, conv_pass, state0
    )

    # Match→literal demotion under the final lengths (dynamic only).
    # Demoted spans re-enter the chain as literal runs, so the emission
    # token mask is the carried mask plus the covered positions.
    demoted, covered = _post_optimize_full(
        best_len, best_off, window, lit_len, off_len, length, n_pad, is_tok
    )
    best_len = jnp.where(is_dyn[:, None], demoted, best_len)
    emit_tok = jnp.where(is_dyn[:, None], is_tok | covered, is_tok)

    return {
        "is_dynamic": is_dyn,
        "lit_len": lit_len,
        "off_len": off_len,
        "f_lit": f_lit,
        "f_off": f_off,
        "best_len": best_len,
        "best_off": best_off,
        "emit_tok": emit_tok,
    }


@jax.jit
def _plan_tables(is_dyn, f_lit, f_off, lit_len, off_len):
    """The block's final tables from its final histograms and lengths:
    the Zopfli RLE A/B test, the CL-mask search and the codewords. Its
    own program because it does not depend on the block size: one
    compilation per lane count serves every n_pad bucket (the mask
    search is most of the planner's program)."""
    static_lit_len = jnp.asarray(_STATIC_LIT_LEN)
    static_lit_cw = jnp.asarray(_STATIC_LIT_CW)
    static_off_len = jnp.asarray(_STATIC_OFF_LEN)
    static_off_cw = jnp.asarray(_STATIC_OFF_CW)

    # Zopfli RLE histogram A/B test.
    cur_cost = dynamic_cost_given(f_lit, f_off, lit_len, off_len)
    o_lit = optimize_for_rle_jax(f_lit)
    o_off = optimize_for_rle_jax(f_off)
    o_lit_len = build_lengths(o_lit, 15)
    o_off_len = build_lengths(o_off, 15)
    opt_cost = dynamic_cost_given(o_lit, o_off, o_lit_len, o_off_len)
    adopt = opt_cost < cur_cost
    lit_len = jnp.where(adopt[:, None], o_lit_len, lit_len)
    off_len = jnp.where(adopt[:, None], o_off_len, off_len)

    # CL-mask search over the final lengths.
    best_mask, cl_len, n_lit, n_off = mask_search(lit_len, off_len)

    # Final codewords.
    lit_cw = jnp.where(
        is_dyn[:, None], canonical_codewords(lit_len), static_lit_cw[None, :]
    )
    off_cw = jnp.where(
        is_dyn[:, None], canonical_codewords(off_len), static_off_cw[None, :]
    )
    lit_len_f = jnp.where(is_dyn[:, None], lit_len, static_lit_len[None, :])
    off_len_f = jnp.where(is_dyn[:, None], off_len, static_off_len[None, :])
    return {
        "lit_len": lit_len,
        "off_len": off_len,
        "best_mask": best_mask,
        "cl_len": cl_len,
        "n_lit": n_lit,
        "n_off": n_off,
        "lit_cw": lit_cw,
        "off_cw": off_cw,
        "lit_len_f": lit_len_f,
        "off_len_f": off_len_f,
    }


@functools.partial(jax.jit, static_argnames=("n_pad",))
def _emit_part(window, best_len, best_off, lit_cw, lit_len_f, off_cw,
               off_len_f, length, emit_tok, n_pad: int):
    return _emit_tokens(
        window, best_len, best_off, lit_cw, lit_len_f, off_cw, off_len_f,
        length, n_pad, emit_tok,
    )


def _plan_block_kernel(window, mlens, moffs, length, n_pad: int,
                       greedy_tok=None):
    """Full per-block planning: the core program, the tables program and
    token emission, three device dispatches."""
    return _compose_plan(
        lambda w, ml, mo, ln, tok: _plan_block_core(w, ml, mo, ln, n_pad, tok),
        _plan_tables,
        functools.partial(_emit_part, n_pad=n_pad),
        window, mlens, moffs, length, greedy_tok,
    )


def _compose_plan(core_fn, tables_fn, emit_fn, window, mlens, moffs, length,
                  greedy_tok):
    """Wire core -> tables -> emit and gather the plan's fields. The three
    callables take the arguments of ``_plan_block_core``, ``_plan_tables``
    and ``_emit_part`` with n_pad bound."""
    core = core_fn(window, mlens, moffs, length, greedy_tok)
    tables = tables_fn(
        core["is_dynamic"], core["f_lit"], core["f_off"], core["lit_len"],
        core["off_len"],
    )
    words, total_bits = emit_fn(
        window, core["best_len"], core["best_off"], tables["lit_cw"],
        tables["lit_len_f"], tables["off_cw"], tables["off_len_f"], length,
        core["emit_tok"],
    )
    return {
        "is_dynamic": core["is_dynamic"],
        "best_len": core["best_len"],
        "best_off": core["best_off"],
        **{k: tables[k] for k in ("lit_len", "off_len", "best_mask", "cl_len",
                                  "n_lit", "n_off")},
        "words": words,
        "total_bits": total_bits,
    }


def _bucket(n: int) -> int:
    size = TILE
    while size < n:
        size *= 2
    return size


# Coalesce small size-buckets into one lane batch. The DP's serial walk
# is shared by a bucket's lanes, but buckets run one after another, so
# padding the ≤32 KiB stragglers up to one shared n_pad saves their
# buckets' 4 DP passes. Larger blocks keep their own buckets: the
# histogram and emission stages scale with B × n_pad.
_MERGE_CAP = 1 << 15


def _merge_small_buckets(buckets: dict[int, list[int]]) -> None:
    small = [k for k in buckets if k <= _MERGE_CAP]
    if len(small) > 1:
        tgt = max(small)
        merged: list[int] = []
        for k in sorted(small):
            merged.extend(buckets.pop(k))
        buckets[tgt] = sorted(merged)


@functools.partial(jax.jit, static_argnames=("n_pad",))
def _slice_blocks(win_ext, lens_ext, offs_ext, starts, n_pad: int):
    """Cut B block lanes out of device-resident window/table arrays
    (padded so every slice is in-bounds — lane data beyond each block's
    length is garbage, which the planning kernel masks everywhere)."""
    def one(s):
        w = lax.dynamic_slice(win_ext, (s,), (n_pad,))
        ml = lax.dynamic_slice(
            lens_ext, (s, 0), (n_pad, NMATCHES_PER_OFFSET)
        ).astype(jnp.int32)
        mo = lax.dynamic_slice(
            offs_ext, (s, 0), (n_pad, NMATCHES_PER_OFFSET)
        ).astype(jnp.int32)
        return w, ml, mo

    return jax.vmap(one)(starts)


def _collect_plans(out, idxs, plans):
    # ONE bulk device->host fetch for the whole batch — per-lane
    # per-field fetches would pay a device round trip hundreds of times
    # per bucket. best_len/best_off are kernel-internal (the words
    # already encode the choices) — dropping them saves
    # 2 x B x n_pad x 4 B of device-to-host traffic per bucket.
    out = {k: v for k, v in out.items() if k not in ("best_len", "best_off")}
    out = jax.device_get(out)
    total_bits = out["total_bits"]
    for b, i in enumerate(idxs):
        n_words = (int(total_bits[b]) + 31) // 32
        plans[i] = {
            "is_dynamic": bool(out["is_dynamic"][b]),
            "lit_len": out["lit_len"][b],
            "off_len": out["off_len"][b],
            "best_mask": int(out["best_mask"][b]),
            "cl_len": out["cl_len"][b],
            "n_lit": int(out["n_lit"][b]),
            "n_off": int(out["n_off"][b]),
            "total_bits": int(total_bits[b]),
            "words": out["words"][b, :n_words],
        }


def plan_blocks_device(win_dev, lens_dev, offs_dev, block_spans):
    """plan_blocks over DEVICE-resident inputs: the window (n,) uint8 and
    the uint16 (n, 8) match length/offset arrays never visit the host —
    block lanes are device slices, and only each plan's packed words +
    ~400 B of tables download."""
    n = win_dev.shape[0]
    buckets: dict[int, list[int]] = {}
    for i, (s, e) in enumerate(block_spans):
        buckets.setdefault(_bucket(e - s), []).append(i)
    _merge_small_buckets(buckets)

    plans: list[dict | None] = [None] * len(block_spans)
    for n_pad, idxs in sorted(buckets.items()):
        B = 1
        while B < len(idxs):
            B *= 2
        # Pad so start + n_pad stays in-bounds (dynamic_slice would
        # otherwise clamp the start and shift real data into the lane).
        win_ext = jnp.concatenate([win_dev, jnp.zeros(n_pad, jnp.uint8)])
        z = jnp.zeros((n_pad, NMATCHES_PER_OFFSET), lens_dev.dtype)
        lens_ext = jnp.concatenate([lens_dev, z])
        offs_ext = jnp.concatenate([offs_dev, z])
        starts = np.zeros(B, np.int32)
        lengths = np.zeros(B, np.int32)
        for b, i in enumerate(idxs):
            s, e = block_spans[i]
            starts[b] = s
            lengths[b] = e - s
        win, ml, mo = _slice_blocks(
            win_ext, lens_ext, offs_ext, jnp.asarray(starts), n_pad
        )
        out = _plan_block_kernel(win, ml, mo, jnp.asarray(lengths), n_pad)
        _collect_plans(out, idxs, plans)
    return plans


@functools.partial(jax.jit, static_argnames=("n_pad",))
def _slice_blocks_multi(win_ext, lens_ext, offs_ext, tok_ext, widx, starts,
                        n_pad: int):
    """Cut B block lanes out of STACKED device window/table arrays
    ((W, n_lane[+pad]) layouts): lane b is window widx[b]'s slice at
    starts[b]. Callers pre-extend the stacks by ≥ n_pad columns so every
    slice is in-bounds."""
    def one(w, s):
        win = lax.dynamic_slice(win_ext, (w, s), (1, n_pad))[0]
        ml = lax.dynamic_slice(
            lens_ext, (w, s, 0), (1, n_pad, NMATCHES_PER_OFFSET)
        )[0].astype(jnp.int32)
        mo = lax.dynamic_slice(
            offs_ext, (w, s, 0), (1, n_pad, NMATCHES_PER_OFFSET)
        )[0].astype(jnp.int32)
        tok = lax.dynamic_slice(tok_ext, (w, s), (1, n_pad))[0]
        return win, ml, mo, tok

    return jax.vmap(one)(widx, starts)


def _shard_lanes(mesh, fn, n_args: int):
    """jit(shard_map(fn)) with every argument and result split on its
    lane axis over all mesh devices."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    spec = P(("dp", "sp"))
    return jax.jit(shard_map(fn, mesh=mesh, in_specs=(spec,) * n_args,
                             out_specs=spec, check_vma=False))


@functools.lru_cache(maxsize=None)
def _plan_tables_sharded(mesh):
    return _shard_lanes(mesh, _plan_tables, 5)


@functools.lru_cache(maxsize=None)
def _plan_block_kernel_sharded(mesh, n_pad: int):
    """The batched block planner over BOTH mesh axes: block lanes
    distribute across every chip. Blocks are fully independent given
    their lane data (matches reference earlier bytes via offsets only),
    so the distribution needs no collectives at all. Each of the three
    programs is its own shard_map, and the tables program is shared by
    every n_pad bucket, as on one device."""
    core_fn = _shard_lanes(
        mesh,
        lambda w, ml, mo, ln, tok: _plan_block_core(w, ml, mo, ln, n_pad, tok),
        5,
    )
    emit_fn = _shard_lanes(mesh, functools.partial(_emit_part, n_pad=n_pad), 9)
    return lambda w, ml, mo, ln, tok: _compose_plan(
        core_fn, _plan_tables_sharded(mesh), emit_fn, w, ml, mo, ln, tok
    )


def plan_blocks_device_multi(win_stack, lens_stack, offs_stack, lanes,
                             mesh=None, tok_stack=None):
    """plan_blocks over blocks drawn from a BATCH of device-resident
    window lanes: ``win_stack`` (W, n_lane) uint8, ``lens_stack``/
    ``offs_stack`` (W, n_lane, 8) uint16, ``lanes`` a list of
    (window_index, start_in_lane, length) for every block of every
    window. All blocks bucket by padded size ACROSS windows, so the
    planning kernel's serial DP scan amortizes over the whole window
    batch instead of running once per window. With ``mesh``, every
    bucket's lanes additionally distribute across all mesh devices
    (shard_map over dp×sp) — the composed begin-phase's chip-scaling
    axis. ``tok_stack`` (W, n_lane) bool: the splitter's window-global
    greedy token marks — sliced per block so the planner's greedy
    histogram reuses the chain instead of re-walking it.
    Returns plans in ``lanes`` order."""
    if not lanes:
        return []
    if tok_stack is None:
        # The sharded kernel's signature is fixed; without real marks the
        # kernel must re-walk, so the mesh path requires them.
        assert mesh is None, "mesh path requires the splitter's token marks"
        tok_stack = jnp.zeros(win_stack.shape, jnp.bool_)
        have_tok = False
    else:
        have_tok = True
    n_dev = 1 if mesh is None else int(np.prod(list(mesh.shape.values())))
    buckets: dict[int, list[int]] = {}
    for i, (_, _, ln) in enumerate(lanes):
        buckets.setdefault(_bucket(ln), []).append(i)
    _merge_small_buckets(buckets)
    n_pad_max = max(buckets)
    W = win_stack.shape[0]
    win_ext = jnp.concatenate(
        [win_stack, jnp.zeros((W, n_pad_max), jnp.uint8)], axis=1
    )
    z = jnp.zeros((W, n_pad_max, NMATCHES_PER_OFFSET), lens_stack.dtype)
    lens_ext = jnp.concatenate([lens_stack, z], axis=1)
    offs_ext = jnp.concatenate([offs_stack, z], axis=1)
    tok_ext = jnp.concatenate(
        [tok_stack, jnp.zeros((W, n_pad_max), jnp.bool_)], axis=1
    )

    plans: list[dict | None] = [None] * len(lanes)
    for n_pad, idxs in sorted(buckets.items()):
        B = n_dev
        while B < len(idxs):
            B *= 2
        widx = np.zeros(B, np.int32)
        starts = np.zeros(B, np.int32)
        lengths = np.zeros(B, np.int32)
        for b, i in enumerate(idxs):
            widx[b], starts[b], lengths[b] = lanes[i]
        win, ml, mo, tok = _slice_blocks_multi(
            win_ext, lens_ext, offs_ext, tok_ext, jnp.asarray(widx),
            jnp.asarray(starts), n_pad,
        )
        gtok = tok if have_tok else None
        if mesh is None:
            out = _plan_block_kernel(win, ml, mo, jnp.asarray(lengths), n_pad, gtok)
        else:
            out = _plan_block_kernel_sharded(mesh, n_pad)(
                win, ml, mo, jnp.asarray(lengths), tok
            )
        _collect_plans(out, idxs, plans)
    return plans


def plan_blocks(window, match_table, block_spans):
    """Plan every block of a window on the device in bucketed batches.

    ``window``: (n,) uint8 window buffer (history + input);
    ``match_table``: (n, 8, 2) int32; ``block_spans``: [(s, e), ...] in
    window coordinates. Returns one plan dict per block with numpy
    values; 'words' is trimmed to ceil(total_bits/32)."""
    window = np.asarray(window, dtype=np.uint8)
    mt = np.asarray(match_table, dtype=np.int32)

    buckets: dict[int, list[int]] = {}
    for i, (s, e) in enumerate(block_spans):
        buckets.setdefault(_bucket(e - s), []).append(i)

    plans: list[dict | None] = [None] * len(block_spans)
    for n_pad, idxs in sorted(buckets.items()):
        # Lane count padded to a power of two: few compiled (B, n_pad)
        # shapes instead of one executable per exact block count.
        B = 1
        while B < len(idxs):
            B *= 2
        win = np.zeros((B, n_pad), np.uint8)
        ml = np.zeros((B, n_pad, NMATCHES_PER_OFFSET), np.int32)
        mo = np.zeros((B, n_pad, NMATCHES_PER_OFFSET), np.int32)
        lens = np.zeros((B,), np.int32)
        for b, i in enumerate(idxs):
            s, e = block_spans[i]
            win[b, : e - s] = window[s:e]
            ml[b, : e - s] = mt[s:e, :, 0]
            mo[b, : e - s] = mt[s:e, :, 1]
            lens[b] = e - s
        out = _plan_block_kernel(
            jnp.asarray(win), jnp.asarray(ml), jnp.asarray(mo),
            jnp.asarray(lens), n_pad,
        )
        _collect_plans(out, idxs, plans)
    return plans
