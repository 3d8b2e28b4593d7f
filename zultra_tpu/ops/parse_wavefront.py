"""Blocked-wavefront optimal-parse DP: the backward cost DP evaluated
tile-by-tile with an exact in-tile min-plus fixpoint, instead of the
position-by-position scan (ops/parse_jax.py) or the host loop.

Semantics replicate reference src/blockdeflate.c:254-323 exactly:
literal vs match with truncated lengths below LEAVE_ALONE_MATCH_SIZE,
offsets' bit costs under the current code lengths, strict-improvement
tie-breaking (literal first, matches longest-first, truncations
descending).

Structure (one jit per padded block size):
  * tiles are processed back-to-front (sequential fori — the DP's data
    dependence), but *within* a tile everything is parallel:
      - the literal-chain closure is exact in one pass: cost via
        min_j (P[j] + cost[j]) - P[i], a suffix cummin over the tile
        (P = prefix sums of literal bit costs);
      - truncated-length match arcs are 37 static shifted adds
        (k = 3..39), with the per-k cheapest offset taken from a
        prefix-min over the match list (matches are sorted by length,
        so eligibility is a prefix);
      - long matches (≥ LEAVE_ALONE) are 8 gathered adds.
    The tile iterates [closure → relax] to fixpoint (while_loop): costs
    are monotone non-increasing and the block DP is a DAG shortest path,
    so the fixpoint equals the exact DP values.
  * a final vectorized selection pass recomputes, from the converged
    cost array, each position's chosen (length, offset) in the exact
    reference scan order (strict improvements; within a match, larger
    truncation wins ties) — values are unique, choices are order-defined.

The planner uses only the scan half of this module (_prep, _osmin_k,
_dp_scan_cost, _select_pass); the tiled wavefront is kept for the
cross-validation tests.
"""

from __future__ import annotations

import functools
import os

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
)

INF = jnp.int32(1 << 27)
TILE = int(os.environ.get("ZULTRA_WAVEFRONT_TILE", "4096"))
N_KS = LEAVE_ALONE_MATCH_SIZE - MIN_MATCH_SIZE  # 37 truncation lengths


def _varlen_tables(lit_lens):
    len_sym = jnp.asarray(np.asarray(MATCHLEN_SYMBOL))
    len_extra = jnp.asarray(np.asarray(MATCHLEN_EXTRA_BITS))
    return len_sym, len_extra, lit_lens[len_sym] + len_extra  # varlen by enc_len


def _prep(lit_lens, off_lens, window, mlens, moffs, length, n_pad):
    """Shared per-position statics for both DP formulations. All RFC
    symbol maps run as closed-form elementwise arithmetic + small selects
    (ops/symbol_map) — no (n, 8)-shaped table gathers."""
    from .symbol_map import (
        matchlen_sym_extra_base,
        offset_sym_extra_base,
        select_by_symbol,
    )

    _, _, varlen_by_e = _varlen_tables(lit_lens)

    idx = jnp.arange(n_pad, dtype=jnp.int32)
    in_block = idx < length
    remaining = jnp.maximum(length - idx, 0)

    lit_cost = jnp.where(in_block, lit_lens[window.astype(jnp.int32)], 0)

    # Per (position, match) statics.
    valid = mlens >= MIN_MATCH_SIZE  # (n, 8)
    clamped = jnp.minimum(mlens, remaining[:, None])
    oidx_raw = moffs - 1
    oidx = jnp.where(oidx_raw < 256, oidx_raw, 256 + ((oidx_raw - 256) >> 7))
    oidx = jnp.clip(oidx, 0, 511)
    osym, oextra, _ = offset_sym_extra_base(oidx)
    osize = select_by_symbol(off_lens, osym, 0, 30, 0) + oextra  # (n, 8)

    long_mask = valid & (mlens >= LEAVE_ALONE_MATCH_SIZE)
    e_raw = clamped - MIN_MATCH_SIZE
    e = jnp.where((e_raw < 0) | (e_raw > 255), 255, e_raw)
    lsym, lextra, _ = matchlen_sym_extra_base(e)
    varlen_e = select_by_symbol(lit_lens, lsym, 257, 286, 0) + lextra
    long_cost_static = jnp.where(long_mask, varlen_e + osize, INF)
    long_step = jnp.where(long_mask, jnp.maximum(clamped, 1), 1)  # cost[i+step]

    short_mask = valid & (mlens < LEAVE_ALONE_MATCH_SIZE)
    short_clamped = jnp.where(short_mask, clamped, 0)  # (n, 8), descending in m
    # Running min of osize over the shorts prefix (longs contribute INF).
    short_osize = jnp.where(short_mask, osize, INF)
    run_min = lax.cummin(short_osize, axis=1)  # (n, 8)
    n_long = jnp.sum(long_mask.astype(jnp.int32), axis=1)  # (n,)

    ks = jnp.arange(MIN_MATCH_SIZE, LEAVE_ALONE_MATCH_SIZE, dtype=jnp.int32)  # (37,)
    varlen_k = varlen_by_e[ks - MIN_MATCH_SIZE]  # (37,)
    return (
        in_block, lit_cost, clamped, osize, long_cost_static, long_step,
        short_clamped, run_min, n_long, ks, varlen_k,
    )


def _osmin_k(short_clamped, run_min, n_long, ks):
    """Per-(position, k) cheapest eligible offset cost: prefix-min over
    the length-sorted shorts with at least k bytes. The index can only be
    0..7, so an 8-way elementwise select replaces the (n, 37) gather."""
    cnt_k = jnp.sum(short_clamped[:, :, None] >= ks[None, None, :], axis=1)  # (n, 37)
    sel = jnp.clip(n_long[:, None] + cnt_k - 1, 0, NMATCHES_PER_OFFSET - 1)
    osmin = jnp.full(sel.shape, INF)
    for j in range(NMATCHES_PER_OFFSET):
        osmin = jnp.where(sel == j, run_min[:, j : j + 1], osmin)
    return jnp.where(cnt_k > 0, osmin, INF)  # (n, 37)


@functools.partial(jax.jit, static_argnames=("n_pad",))
def _dp_wavefront(lit_lens, off_lens, window, mlens, moffs, length, n_pad):
    """All arrays are padded to n_pad (a TILE multiple); ``length`` is the
    real block length (traced scalar). Returns (cost, best_len, best_off)
    of shape (n_pad,) — entries past length are zero."""
    (
        in_block, lit_cost, clamped, osize, long_cost_static, long_step,
        short_clamped, run_min, n_long, ks, varlen_k,
    ) = _prep(lit_lens, off_lens, window, mlens, moffs, length, n_pad)

    # Initial costs: final zeros beyond the block, INF inside it.
    cost0 = jnp.where(in_block, INF, 0)
    cost = jnp.concatenate([cost0, jnp.zeros(TILE + 260, jnp.int32)])

    n_tiles = n_pad // TILE

    def tile_body(t_rev, cost):
        t0 = (n_tiles - 1 - t_rev) * TILE

        lit_t = lax.dynamic_slice(lit_cost, (t0,), (TILE,))
        in_t = lax.dynamic_slice(in_block, (t0,), (TILE,))
        sc_t = lax.dynamic_slice(short_clamped, (t0, 0), (TILE, NMATCHES_PER_OFFSET))
        rm_t = lax.dynamic_slice(run_min, (t0, 0), (TILE, NMATCHES_PER_OFFSET))
        nl_t = lax.dynamic_slice(n_long, (t0,), (TILE,))
        lcs_t = lax.dynamic_slice(long_cost_static, (t0, 0), (TILE, NMATCHES_PER_OFFSET))
        lstep_t = lax.dynamic_slice(long_step, (t0, 0), (TILE, NMATCHES_PER_OFFSET))

        # Per-k eligible-short count and its cheapest offset (prefix-min).
        osmin_k = _osmin_k(sc_t, rm_t, nl_t, ks)  # (T, 37)

        P = jnp.concatenate([jnp.zeros(1, jnp.int32), jnp.cumsum(lit_t)])  # (T+1,)
        rel = jnp.arange(TILE, dtype=jnp.int32)

        def fix_body(state):
            cost, _ = state
            halo = lax.dynamic_slice(cost, (t0,), (TILE + 260,))

            # Exact literal closure: min over j ≥ i of P[j]+cost[j] - P[i].
            pc = P + halo[: TILE + 1]
            suffmin = lax.cummin(pc, reverse=True)
            c_lit = suffmin[:TILE] - P[:TILE]

            # Truncated matches: 37 shifted adds.
            best_short = jnp.full((TILE,), INF)
            for kk in range(N_KS):
                k = MIN_MATCH_SIZE + kk
                future = lax.dynamic_slice(halo, (k,), (TILE,))
                best_short = jnp.minimum(
                    best_short, varlen_k[kk] + osmin_k[:, kk] + future
                )

            # Long matches: 8 gathered adds.
            best_long = jnp.full((TILE,), INF)
            for m in range(NMATCHES_PER_OFFSET):
                future = halo[jnp.clip(rel + lstep_t[:, m], 0, TILE + 259)]
                best_long = jnp.minimum(best_long, lcs_t[:, m] + future)

            new_tile = jnp.minimum(c_lit, jnp.minimum(best_short, best_long))
            new_tile = jnp.where(in_t, new_tile, halo[:TILE])
            changed = jnp.any(new_tile < halo[:TILE])
            cost = lax.dynamic_update_slice(cost, new_tile, (t0,))
            return cost, changed

        def fix_cond(state):
            _, changed = state
            return changed

        cost, _ = lax.while_loop(fix_cond, fix_body, fix_body((cost, jnp.bool_(True))))
        return cost

    cost = lax.fori_loop(0, n_tiles, tile_body, cost)

    best_len, best_off = _select_pass(
        cost, lit_cost, mlens, moffs, osize, clamped, long_cost_static,
        long_step, in_block, ks, varlen_k, n_pad,
    )
    return cost[:n_pad], best_len, best_off


def _select_pass(cost, lit_cost, mlens, moffs, osize, clamped,
                 long_cost_static, long_step, in_block, ks, varlen_k, n_pad):
    """Order-exact (length, offset) selection from converged costs —
    reproduces the reference's strict-improvement scan per position.
    ``cost`` is the extended array (n_pad + TILE + 260)."""
    n_tiles = n_pad // TILE

    def select_tile(t_rev, best):
        best_len_all, best_off_all = best
        t0 = t_rev * TILE
        halo = lax.dynamic_slice(cost, (t0,), (TILE + 260,))
        lit_t = lax.dynamic_slice(lit_cost, (t0,), (TILE,))
        ml_t = lax.dynamic_slice(mlens, (t0, 0), (TILE, NMATCHES_PER_OFFSET))
        mo_t = lax.dynamic_slice(moffs, (t0, 0), (TILE, NMATCHES_PER_OFFSET))
        os_t = lax.dynamic_slice(osize, (t0, 0), (TILE, NMATCHES_PER_OFFSET))
        cl_t = lax.dynamic_slice(clamped, (t0, 0), (TILE, NMATCHES_PER_OFFSET))
        lcs_t = lax.dynamic_slice(long_cost_static, (t0, 0), (TILE, NMATCHES_PER_OFFSET))
        lstep_t = lax.dynamic_slice(long_step, (t0, 0), (TILE, NMATCHES_PER_OFFSET))
        rel = jnp.arange(TILE, dtype=jnp.int32)

        b_cost = lit_t + halo[1 : TILE + 1]
        b_len = jnp.zeros(TILE, jnp.int32)
        b_off = jnp.zeros(TILE, jnp.int32)

        # future costs for every truncation: (T, 37)
        fut_k = jnp.stack(
            [lax.dynamic_slice(halo, (MIN_MATCH_SIZE + kk,), (TILE,)) for kk in range(N_KS)],
            axis=1,
        )

        def eval_m(m, state):
            b_cost, b_len, b_off = state
            raw = ml_t[:, m]
            valid_m = raw >= MIN_MATCH_SIZE
            is_long = raw >= LEAVE_ALONE_MATCH_SIZE

            long_c = lcs_t[:, m] + halo[jnp.clip(rel + lstep_t[:, m], 0, TILE + 259)]
            long_l = cl_t[:, m]

            kmask = ks[None, :] <= cl_t[:, m][:, None]
            vals = jnp.where(kmask, varlen_k[None, :] + os_t[:, m][:, None] + fut_k, INF)
            short_c = jnp.min(vals, axis=1)
            # Tie-break: the reference scans k downward — larger k wins ties.
            k_sel = jnp.max(
                jnp.where(vals == short_c[:, None], ks[None, :], 0), axis=1
            )

            cand_c = jnp.where(is_long, long_c, short_c)
            cand_l = jnp.where(is_long, long_l, k_sel)
            better = valid_m & (b_cost > cand_c)
            return (
                jnp.where(better, cand_c, b_cost),
                jnp.where(better, cand_l, b_len),
                jnp.where(better, mo_t[:, m], b_off),
            )

        b_cost, b_len, b_off = lax.fori_loop(
            0, NMATCHES_PER_OFFSET, eval_m, (b_cost, b_len, b_off)
        )
        in_t = lax.dynamic_slice(in_block, (t0,), (TILE,))
        b_len = jnp.where(in_t, b_len, 0)
        b_off = jnp.where(in_t, b_off, 0)
        best_len_all = lax.dynamic_update_slice(best_len_all, b_len, (t0,))
        best_off_all = lax.dynamic_update_slice(best_off_all, b_off, (t0,))
        return best_len_all, best_off_all

    best0 = (jnp.zeros(n_pad, jnp.int32), jnp.zeros(n_pad, jnp.int32))
    return lax.fori_loop(0, n_tiles, select_tile, best0)


def _dp_scan_cost(lit_cost, osmin_k, long_cost_static, long_step,
                  length, varlen_k, n_pad):
    """Exact backward cost DP as ONE lax.scan over positions: ~7 vector
    ops per step via the per-k cheapest-offset prefix-min (osmin_k), with
    the order-exact (length, offset) choices reconstructed afterwards by
    ``_select_pass`` from the converged costs. Batched blocks ride as
    vmap lanes of the same scan.

    Beyond-block positions need no masking: lit_cost is 0 there (_prep)
    and the ring carries zeros forward, so best = min(0+0, ·) = 0, which
    is exactly the DP's boundary condition."""
    RINGN = 259

    # Fold the per-k length cost into the offset prefix-min, and pre-clip
    # the long-step ring indices — three fewer ops inside the step.
    short_static = jnp.minimum(varlen_k[None, :] + osmin_k, INF)
    lstep_idx = jnp.clip(long_step - 1, 0, RINGN - 1)

    def step(ring, inp):
        lcost, sstat, lcs, lidx = inp
        # shorts: cost[pos+k] = ring[k-1], k = 3..39 → static slice.
        short = jnp.min(
            sstat + lax.slice_in_dim(ring, MIN_MATCH_SIZE - 1,
                                     LEAVE_ALONE_MATCH_SIZE - 1, axis=0),
            axis=-1,
        )
        long_ = jnp.min(lcs + ring[lidx], axis=-1)
        best = jnp.minimum(lcost + ring[0], jnp.minimum(short, long_))
        ring = jnp.concatenate([best[None], ring[:-1]])
        return ring, best

    ring0 = jnp.zeros(RINGN, jnp.int32)
    xs = (
        lit_cost[::-1],
        short_static[::-1],
        long_cost_static[::-1],
        lstep_idx[::-1],
    )
    # unroll: the step is ~7 tiny vector ops, so the while-loop trip
    # bookkeeping dominates; unrolling packs 8 positions per trip.
    _, cost_rev = lax.scan(step, ring0, xs, unroll=8)
    return cost_rev[::-1]


@functools.partial(jax.jit, static_argnames=("n_pad",))
def _dp_scan_batch(lit_lens, off_lens, windows, mlens, moffs, lengths, n_pad):
    """Batched scan DP + order-exact selection; same contract as
    ``_dp_wavefront_batch``."""
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
        best_len, best_off = _select_pass(
            cost_ext, lit_cost, ml, mo, osize, clamped, long_cost_static,
            long_step, in_block, ks, varlen_k, n_pad,
        )
        return cost, best_len, best_off

    return jax.vmap(one)(lit_lens, off_lens, windows, mlens, moffs, lengths)


@functools.partial(jax.jit, static_argnames=("n_pad",))
def _dp_wavefront_batch(lit_lens, off_lens, windows, mlens, moffs, lengths, n_pad):
    """Batched wavefront DP: vmap of ``_dp_wavefront`` over independent
    blocks (the sequential tile loop's ~45 small ops per tile amortize
    over the batch). All leading dims are the batch axis; each lane carries its
    own code-length tables. The batched while_loop runs until every lane's
    tile fixpoint converges — lanes that converge early recompute
    identical values, which is the exactness-preserving form of batching a
    data-dependent loop."""
    return jax.vmap(
        lambda ll, ol, w, ml, mo, ln: _dp_wavefront(ll, ol, w, ml, mo, ln, n_pad)
    )(lit_lens, off_lens, windows, mlens, moffs, lengths)


def optimize_matches_wavefront_batch(jobs, method: str = "wavefront"):
    """Run the DP for a batch of independent blocks in one device program.

    ``jobs``: list of (lit_lens, off_lens, window, match_table, start, end)
    with the same contract as ``optimize_matches_wavefront``. Blocks are
    padded to the largest job's TILE-multiple so one executable serves the
    whole batch. ``method``: 'wavefront' (tile fixpoint) or 'scan' (one
    backward lax.scan per lane — the latency-lean form; see
    ``_dp_scan_cost``). Returns a list of (end, 2) int32 best arrays.
    """
    if not jobs:
        return []
    n_pad = max(-(-(e - s) // TILE) * TILE for (_, _, _, _, s, e) in jobs)
    B = len(jobs)
    lit = np.zeros((B, len(np.asarray(jobs[0][0]))), np.int32)
    off = np.zeros((B, len(np.asarray(jobs[0][1]))), np.int32)
    wins = np.zeros((B, n_pad), np.uint8)
    ml = np.zeros((B, n_pad, NMATCHES_PER_OFFSET), np.int32)
    mo = np.zeros((B, n_pad, NMATCHES_PER_OFFSET), np.int32)
    lens = np.zeros((B,), np.int32)
    for b, (ll, ol, window, table, s, e) in enumerate(jobs):
        length = e - s
        lit[b] = np.asarray(ll, np.int32)
        off[b] = np.asarray(ol, np.int32)
        wins[b, :length] = np.asarray(window[s:e], np.uint8)
        t = np.asarray(table[s:e], np.int32)
        ml[b, :length] = t[:, :, 0]
        mo[b, :length] = t[:, :, 1]
        lens[b] = length
    fn = _dp_scan_batch if method == "scan" else _dp_wavefront_batch
    _, best_len, best_off = fn(
        jnp.asarray(lit), jnp.asarray(off), jnp.asarray(wins),
        jnp.asarray(ml), jnp.asarray(mo), jnp.asarray(lens), n_pad,
    )
    best_len = np.asarray(best_len)
    best_off = np.asarray(best_off)
    outs = []
    for b, (_, _, _, _, s, e) in enumerate(jobs):
        length = e - s
        out = np.zeros((e, 2), dtype=np.int32)
        out[s:e, 0] = best_len[b, :length]
        out[s:e, 1] = best_off[b, :length]
        outs.append(out)
    return outs


def optimize_matches_wavefront(lit_lens, off_lens, window, match_table, start, end):
    """Drop-in DP with the same contract as native zn_optimize_matches /
    ops.parse_jax.optimize_matches_jax: (end, 2) int32 best-match array."""
    length = end - start
    n_pad = -(-length // TILE) * TILE
    win = np.zeros(n_pad, dtype=np.uint8)
    win[:length] = np.asarray(window[start:end], dtype=np.uint8)
    mt = np.zeros((n_pad, NMATCHES_PER_OFFSET, 2), dtype=np.int32)
    mt[:length] = np.asarray(match_table[start:end], dtype=np.int32)

    _, best_len, best_off = _dp_wavefront(
        jnp.asarray(np.asarray(lit_lens, dtype=np.int32)),
        jnp.asarray(np.asarray(off_lens, dtype=np.int32)),
        jnp.asarray(win),
        jnp.asarray(mt[:, :, 0]),
        jnp.asarray(mt[:, :, 1]),
        jnp.int32(length),
        n_pad,
    )
    out = np.zeros((end, 2), dtype=np.int32)
    out[start:end, 0] = np.asarray(best_len[:length])
    out[start:end, 1] = np.asarray(best_off[:length])
    return out
