"""Device block splitter: the recursive entropy-drift split computed as
level-synchronous batched device passes — no sequential token walk.

Replaces the semantics of the reference's recursive splitter
(reference src/blockdeflate.c:634-813; host ports: blocks.py
_split_recursive, native split_recursive) with a parallel construction
built on two exactness observations:

1. **Checkpoints are decision-independent.** The reference walk resets
   its token counter at every checkpoint, but never resets the
   cumulative ``stat`` histogram, and drift triggers don't alter the
   cadence — so checkpoint token indices have the closed form
   c_k = t1 + 256(k-1), with t1 = max(ts+255, first token ending ≥
   start+512) (both conditions monotone). Every per-checkpoint quantity
   (stat, new_stat, n_stats, last_good_split) is a difference of
   prefix sums at those indices.
2. **Left entropies are prefix entropies.** The incremental
   left-accumulation in the reference telescopes: at any trigger,
   left = token entropy over [range start, previous checkpoint], right
   = total - left (with the EOD bin forced to 1 on both sides).

Hence one recursion *level* evaluates its candidates in a flat batch:
drift masks from 18-bucket prefix sums, left/right histograms from a
stride-256 symbol-prefix table plus a ≤256-token partial, and the MK
cost evaluation compacted (round 5) to the first ``trig_cap``
drift-TRIGGERED candidates — the only ones the reference's walk
evaluates — in ONE batched ``entropy_jax.dynamic_cost`` call, with an
exact per-lane overflow retry when a level triggers more than the
budget. Each range's boundary histograms and total cost are CARRIED
across levels (a child's total is exactly the left/right evaluation at
its parent's winning split). The best split per range is a segmented
argmax (delta ≥ 0, earliest on ties — the reference's "first, or
strictly better" rule), and six fori levels reproduce the depth<6
recursion. The ≤64-split cap never binds beyond the depth limit (a
depth-6 tree has ≤63 internal nodes), so no DFS-order emulation is
needed.

Exactness: bit-identical split points vs the host splitter on the fuzz
corpus (tests/test_ops.py); the drift arithmetic stays in int32 — the
reference's uint32 products are bounded by 2^30 because n_new_stats is
exactly 256 whenever n_stats > 0.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..constants import (
    MIN_MATCH_SIZE,
    NEODMARKERSYM,
    NLITERALSYMS,
    NOFFSETSYMS,
    MAX_SPLITS,
)
from .entropy_jax import dynamic_cost

INF32 = jnp.int32(2**30)
NBINS = NLITERALSYMS + NOFFSETSYMS  # 320 combined symbol bins
MAX_RANGES = 64
N_LEVELS = 6  # reference: depth >= 6 prunes


def _token_structure(window, row_len, row_off, prev, n_real, n: int):
    """Greedy token chain from match-table row 0 (the packed-chain
    equivalent of native build_greedy_chain): token starts by pointer
    doubling, then compacted per-token arrays.

    ``n`` is the static padded size; ``prev``/``n_real`` are traced.
    Returns (n_tok, starts, ends, bucket, sym1, sym2) — arrays of
    length n (token t at index t; tail slots padded: starts/ends INF).
    """
    idx = jnp.arange(n, dtype=jnp.int32)
    is_match = row_len >= MIN_MATCH_SIZE
    step = jnp.where(is_match, row_len, 1)

    nxt = jnp.minimum(idx + step, n)
    jmp = jnp.concatenate([nxt, jnp.full((1,), n, jnp.int32)])
    mark = jnp.zeros(n + 1, jnp.int32).at[prev].set(1)
    rounds = max(1, int(math.ceil(math.log2(n + 1))) + 1)
    for _ in range(rounds):
        mark = jnp.maximum(
            mark, jnp.zeros(n + 1, jnp.int32).at[jmp].max(mark, mode="drop")
        )
        jmp = jmp[jmp]
    is_tok = (mark[:n] == 1) & (idx >= prev) & (idx < n_real)

    # Token symbols / buckets at every position (masked by is_tok later);
    # symbol maps as closed-form elementwise arithmetic (ops/symbol_map).
    from .symbol_map import matchlen_sym_extra_base, offset_sym_extra_base

    e = jnp.clip(row_len - MIN_MATCH_SIZE, 0, 255)
    raw_off = jnp.maximum(row_off - 1, 0)
    oidx = jnp.where(raw_off < 256, raw_off, 256 + ((raw_off - 256) >> 7))
    oidx = jnp.clip(oidx, 0, 511)
    len_sym_e, _, _ = matchlen_sym_extra_base(e)
    off_sym_o, _, _ = offset_sym_extra_base(oidx)
    byte = window.astype(jnp.int32)
    sym1 = jnp.where(is_match, len_sym_e, byte)
    sym2 = jnp.where(is_match, NLITERALSYMS + off_sym_o, NBINS)  # NBINS = drop
    bucket = jnp.where(
        is_match,
        jnp.where(row_len >= 9, 17, 16),
        ((byte >> 4) & 0xC) | (byte & 0x3),
    )

    # Compact to token index order: ONE 3-array sort (key + position +
    # packed fields) instead of five scatters.
    n_tok = jnp.sum(is_tok.astype(jnp.int32))
    key = jnp.where(is_tok, idx, INF32)
    packed = (
        step.astype(jnp.uint32)
        | (bucket.astype(jnp.uint32) << 9)
        | (sym1.astype(jnp.uint32) << 14)
        | (sym2.astype(jnp.uint32) << 23)
    )
    _, idx_s, packed_s = lax.sort((key, idx, packed), num_keys=1)
    tok_valid = jnp.arange(n, dtype=jnp.int32) < n_tok
    step_s = (packed_s & 0x1FF).astype(jnp.int32)
    starts = jnp.where(tok_valid, idx_s, INF32)
    ends = jnp.where(tok_valid, idx_s + step_s, INF32)
    bucket_t = jnp.where(
        tok_valid, ((packed_s >> 9) & 0x1F).astype(jnp.int32), 0
    )
    sym1_t = jnp.where(
        tok_valid, ((packed_s >> 14) & 0x1FF).astype(jnp.int32), 0
    )
    sym2_t = jnp.where(
        tok_valid, (packed_s >> 23).astype(jnp.int32), NBINS
    )
    return n_tok, starts, ends, bucket_t, sym1_t, sym2_t, is_tok


def _trig_cap(in_cap: int) -> int:
    """Default triggered-candidate budget: measured trigger density is
    ~60/level on text and ~260/level on mixed data per 1 MB window
    (scripts in round 5) — ~8-33/level at jaxdev's 128 KiB windows — so
    in_cap/2048 with a 64 floor covers real corpora with margin; the
    exact overflow retry handles the rest."""
    return max(64, in_cap >> 11)


@functools.partial(jax.jit, static_argnames=("n", "in_cap", "trig_cap"))
def _split_kernel(window, row_len, row_off, prev, n_real, n: int,
                  in_cap: int | None = None, trig_cap: int = 0):
    """Split points for the window range [prev, n_real). ``n`` is the
    static padded buffer size (few compiled shapes); prev/n_real are
    traced. ``in_cap`` (static) bounds the INPUT bytes (n_real - prev) —
    tokens and checkpoint candidates can never exceed it. ``trig_cap``
    > 0 compacts each level's MK cost evaluation to the first trig_cap
    DRIFT-TRIGGERED candidates (the only ones whose cost the reference
    evaluates); a level with more triggers sets the returned ``ovf``
    flag and the caller retries that lane with trig_cap=0 (exact).
    Returns (splits (64,) int32 ascending with INF padding, n_splits,
    tok_marks, ovf)."""
    if in_cap is None:
        in_cap = n
    n_tok, starts, ends, bucket_t, sym1_t, sym2_t, tok_marks = _token_structure(
        window, row_len, row_off, prev, n_real, n
    )
    tok_valid = jnp.arange(n, dtype=jnp.int32) < n_tok

    # 18-bucket inclusive prefix sums, with a leading zero row:
    # P18[t+1] = counts over tokens [0..t].  Shape (n+1, 18).
    onehot18 = (
        (bucket_t[:, None] == jnp.arange(18, dtype=jnp.int32)[None, :])
        & tok_valid[:, None]
    ).astype(jnp.int32)
    P18 = jnp.concatenate(
        [jnp.zeros((1, 18), jnp.int32), jnp.cumsum(onehot18, axis=0)], axis=0
    )

    # Stride-256 symbol prefix table: P256[q] = symbol counts over tokens
    # [0, 256q).  Shape (n//256 + 2, NBINS+1) (last bin = drop).
    n_q = n // 256 + 2
    qid = jnp.arange(n, dtype=jnp.int32) // 256 + 1
    seg_hist = jnp.zeros((n_q, NBINS + 1), jnp.int32)
    seg_hist = seg_hist.at[jnp.where(tok_valid, qid, n_q - 1), jnp.where(tok_valid, sym1_t, NBINS)].add(1)
    seg_hist = seg_hist.at[jnp.where(tok_valid, qid, n_q - 1), jnp.where(tok_valid & (sym2_t < NBINS), sym2_t, NBINS)].add(1)
    P256 = jnp.cumsum(seg_hist, axis=0)[:, :NBINS]  # (n_q, 320)

    ends_sorted = jnp.where(tok_valid, ends, INF32)  # monotone, INF tail

    def prefix_hist_incl(tok_idx):
        """Symbol histogram over tokens [0, tok_idx] inclusive; tok_idx
        may be -1 (empty). (C,) -> (C, NBINS)."""
        x = tok_idx + 1  # exclusive count
        q = x // 256
        base = q * 256
        h = P256[jnp.clip(q, 0, n_q - 1)]
        # partial: tokens [base, x)
        j = jnp.arange(256, dtype=jnp.int32)[None, :]
        t_part = base[:, None] + j
        m = (t_part < x[:, None]) & (t_part < n_tok)
        t_safe = jnp.clip(t_part, 0, n - 1)
        s1 = jnp.where(m, sym1_t[t_safe], NBINS)
        s2 = jnp.where(m, sym2_t[t_safe], NBINS)
        C = tok_idx.shape[0]
        part = jnp.zeros((C, NBINS + 1), jnp.int32)
        lane = jnp.arange(C)[:, None]
        part = part.at[lane, s1].add(1)
        part = part.at[lane, s2].add(1)
        return h + part[:, :NBINS]

    C_cap = in_cap // 256 + MAX_RANGES  # flat candidate capacity per level

    # Range state. Boundary histograms and total costs are CARRIED
    # across levels instead of recomputed: a child's total histogram and
    # cost are exactly the left/right histogram and cost evaluated at
    # its parent's winning split (the reference recomputes them from the
    # tokens — reference src/blockdeflate.c:614-618 — but the values are
    # identical, so carrying is exact and saves two 64-lane prefix-hist
    # passes plus 64 MK lanes per level).
    r_bs = jnp.full(MAX_RANGES, 0, jnp.int32).at[0].set(prev)
    r_be = jnp.zeros(MAX_RANGES, jnp.int32).at[0].set(n_real)
    r_ts = jnp.zeros(MAX_RANGES, jnp.int32)
    r_te = jnp.zeros(MAX_RANGES, jnp.int32).at[0].set(n_tok)
    r_act = jnp.zeros(MAX_RANGES, jnp.bool_).at[0].set(True)
    n_ranges = jnp.int32(1)
    splits = jnp.full(MAX_SPLITS, INF32)
    n_splits = jnp.int32(0)
    ovf = jnp.zeros((), jnp.bool_)

    # Initial state for range 0: H_ts = prefix over zero tokens = 0.
    hte0 = prefix_hist_incl(jnp.clip(r_te[:1], 1, n) - 1)  # (1, NBINS)
    r_Hts = jnp.zeros((MAX_RANGES, NBINS), jnp.int32)
    r_Hte = jnp.zeros((MAX_RANGES, NBINS), jnp.int32).at[0].set(hte0[0])
    htot0 = hte0.at[:, NEODMARKERSYM].add(1)
    cost0 = dynamic_cost(htot0[:, :NLITERALSYMS], htot0[:, NLITERALSYMS:])
    r_cost = jnp.zeros(MAX_RANGES, cost0.dtype).at[0].set(cost0[0])

    cand_slot = jnp.arange(C_cap, dtype=jnp.int32)
    rng_iota = jnp.arange(MAX_RANGES, dtype=jnp.int32)

    def level_body(_, state):
        (r_bs, r_be, r_ts, r_te, r_act, n_ranges, splits, n_splits,
         r_Hts, r_Hte, r_cost, ovf) = state

        eligible = r_act & ((r_be - r_bs) >= 8192)

        # First checkpoint per range: t1 = max(ts + 255, first token with
        # end >= bs + 512).
        t_byte = jnp.searchsorted(ends_sorted, r_bs + 512, side="left").astype(jnp.int32)
        t1 = jnp.maximum(r_ts + 255, t_byte)
        n_cand = jnp.where(
            eligible & (t1 < r_te), (r_te - t1 + 255) // 256, 0
        )  # candidates at j = 0..n_cand-1

        # Flatten candidates: range id by scatter + running max.
        offs = jnp.cumsum(n_cand) - n_cand
        total_c = offs[-1] + n_cand[-1]
        starts_slot = jnp.where(n_cand > 0, offs, C_cap)
        rng_at = jnp.full(C_cap + 1, jnp.int32(-1)).at[starts_slot].max(
            rng_iota, mode="drop"
        )[:C_cap]
        cand_rng = jnp.maximum(lax.cummax(rng_at), 0)
        slot_valid = cand_slot < total_c
        run_start = lax.cummax(jnp.where(rng_at >= 0, cand_slot, 0))
        cand_j = cand_slot - run_start
        ck = jnp.clip(t1[cand_rng] + 256 * cand_j, 0, n - 1)  # checkpoint token idx
        pi = ck - 256  # previous checkpoint token (j >= 1 only)
        drift_ok = slot_valid & (cand_j >= 1)

        # Drift statistics from P18 prefixes (n_new is always 256).
        ts_c = r_ts[cand_rng]
        pi_s = jnp.clip(pi, 0, n - 1)
        stat = P18[pi_s + 1] - P18[jnp.clip(ts_c, 0, n)]  # (C, 18)
        new = P18[ck + 1] - P18[pi_s + 1]
        n_stats = pi - ts_c + 1
        total_delta = jnp.sum(jnp.abs(stat * 256 - new * n_stats[:, None]), axis=1)
        trigger = drift_ok & (
            (total_delta // 256) >= (n_stats * 45 // 100)
        )

        # Cost evaluation only matters at drift TRIGGERS (exactly like
        # the reference walk). With trig_cap > 0 the level compacts to
        # the first trig_cap triggered slots (ascending, preserving the
        # earliest-on-ties rule); more triggers than that sets ovf and
        # the caller retries exactly. trig_cap = 0 evaluates every slot.
        if trig_cap > 0:
            Kc = min(trig_cap, C_cap)
            okey = jnp.where(trigger, cand_slot, C_cap + cand_slot)
            okey_sorted = lax.sort(okey)
            sel = okey_sorted[:Kc]
            real = sel < C_cap
            sel = jnp.where(real, sel, sel - C_cap)
            ovf = ovf | (jnp.sum(trigger.astype(jnp.int32)) > Kc)
            pi_l = pi_s[sel]
            rng_l = cand_rng[sel]
            slot_l = sel
            lane_iota = jnp.arange(Kc, dtype=jnp.int32)
        else:
            Kc = C_cap
            real = trigger
            pi_l = pi_s
            rng_l = cand_rng
            slot_l = cand_slot
            lane_iota = cand_slot

        H_pi = prefix_hist_incl(pi_l)  # (Kc, NBINS)
        H_tot = (r_Hte - r_Hts)[rng_l].at[:, NEODMARKERSYM].add(1)
        H_left = (H_pi - r_Hts[rng_l]).at[:, NEODMARKERSYM].set(1)
        H_right = (H_tot - H_left).at[:, NEODMARKERSYM].set(1)
        costs = dynamic_cost(
            jnp.concatenate([H_left[:, :NLITERALSYMS], H_right[:, :NLITERALSYMS]]),
            jnp.concatenate([H_left[:, NLITERALSYMS:], H_right[:, NLITERALSYMS:]]),
        )
        left_cost = costs[:Kc]
        right_cost = costs[Kc:]
        delta = (r_cost[rng_l] - (left_cost + right_cost)).astype(jnp.int32)
        good = real & (delta >= 0)
        key = jnp.where(good, delta, -1)

        # Per-range best: max delta, earliest candidate on ties (lane
        # order is ascending original-slot order on both paths).
        best_delta = jnp.full(MAX_RANGES, -1, jnp.int32).at[rng_l].max(key)
        is_best = good & (key == best_delta[rng_l]) & (best_delta[rng_l] >= 0)
        best_lane = jnp.full(MAX_RANGES, Kc, jnp.int32).at[
            jnp.where(is_best, rng_l, MAX_RANGES)
        ].min(lane_iota, mode="drop")
        found = best_lane < Kc

        bl_safe = jnp.clip(best_lane, 0, Kc - 1)
        bs_safe = jnp.clip(slot_l[bl_safe], 0, C_cap - 1)
        sp_tok = pi[bs_safe] + 1  # right child's first token
        sp_byte = ends[jnp.clip(pi[bs_safe], 0, n - 1)]
        Hpi_b = H_pi[bl_safe]  # (64, NBINS) winner boundary hists
        lc_b = left_cost[bl_safe]
        rc_b = right_cost[bl_safe]

        # Emit splits (order is irrelevant; sorted at the end).
        rank = jnp.cumsum(found.astype(jnp.int32)) - found
        n_found = jnp.sum(found.astype(jnp.int32))
        splits = splits.at[
            jnp.where(found, n_splits + rank, MAX_SPLITS)
        ].set(sp_byte, mode="drop")
        n_splits = n_splits + n_found

        # Right child appends at a fresh slot; the parent slot becomes the
        # left child; parents without a split stop recursing.
        new_slot = jnp.where(found, n_ranges + rank, MAX_RANGES)
        r_bs = r_bs.at[new_slot].set(sp_byte, mode="drop")
        r_be = r_be.at[new_slot].set(r_be, mode="drop")
        r_ts = r_ts.at[new_slot].set(sp_tok, mode="drop")
        r_te = r_te.at[new_slot].set(r_te, mode="drop")
        r_act = r_act.at[new_slot].set(True, mode="drop")
        r_Hts = r_Hts.at[new_slot].set(Hpi_b, mode="drop")
        r_Hte = r_Hte.at[new_slot].set(r_Hte, mode="drop")
        r_cost = r_cost.at[new_slot].set(rc_b, mode="drop")

        is_parent = jnp.arange(MAX_RANGES, dtype=jnp.int32) < n_ranges
        pf = is_parent & found
        r_be = jnp.where(pf, sp_byte, r_be)
        r_te = jnp.where(pf, sp_tok, r_te)
        r_Hte = jnp.where(pf[:, None], Hpi_b, r_Hte)
        r_cost = jnp.where(pf, lc_b, r_cost)
        r_act = jnp.where(is_parent, found, r_act)
        n_ranges = n_ranges + n_found
        return (r_bs, r_be, r_ts, r_te, r_act, n_ranges, splits, n_splits,
                r_Hts, r_Hte, r_cost, ovf)

    state = (r_bs, r_be, r_ts, r_te, r_act, n_ranges, splits, n_splits,
             r_Hts, r_Hte, r_cost, ovf)
    state = lax.fori_loop(0, N_LEVELS, level_body, state)
    splits, n_splits, ovf = state[6], state[7], state[11]
    # tok_marks: the window-global greedy token-start mask. The greedy
    # chain is memoryless and split points are token starts, so every
    # block's greedy walk is a subpath — the planner reuses these marks
    # instead of re-walking the chain per block.
    return jnp.sort(splits), n_splits, tok_marks, ovf


def _bucket(n: int) -> int:
    """Static kernel sizes: few distinct shapes → few compiles."""
    size = 8192
    while size < n:
        size *= 2
    return size


@functools.partial(jax.jit, static_argnames=("n", "in_cap", "trig_cap"))
def _split_kernel_batch(win_p, rl, ro, prev, n_real, n: int,
                        in_cap: int | None = None, trig_cap: int = 0):
    """vmap of ``_split_kernel`` over a batch of window lanes — one
    program splits every window of a batch (the level loops' latency
    amortizes across lanes). ``prev`` is shared (the stacked lane layout
    puts the first input byte at the same offset in every lane);
    ``n_real`` is per-lane. Each lane pointer-doubles its token chain
    inside the vmap."""
    return jax.vmap(
        lambda w, l, o, nr: _split_kernel(w, l, o, prev, nr, n, in_cap,
                                          trig_cap=trig_cap)
    )(win_p, rl, ro, n_real)


@functools.lru_cache(maxsize=None)
def _split_kernel_sharded(mesh, n: int, in_cap: int | None = None):
    """shard_map of the batched splitter over BOTH mesh axes: window
    lanes distribute across every chip (the splitter is compute-bound
    per lane, so lanes-across-chips is its scaling axis)."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    spec = P(("dp", "sp"))
    step = shard_map(
        lambda w, l, o, p, nr: _split_kernel_batch(w, l, o, p[0], nr, n, in_cap),
        mesh=mesh,
        in_specs=(spec, spec, spec, P(None), spec),
        out_specs=(spec, spec, spec, spec),
        check_vma=False,
    )
    return jax.jit(step)


def _input_cap(in_size: int) -> int:
    """Static candidate-capacity bucket for ``in_size`` input bytes
    (pow2, ≥ the smallest legal block size → few compiled shapes)."""
    cap = 32768
    while cap < in_size:
        cap *= 2
    return cap


def block_split_jax(window, match_table, prev: int, in_size: int):
    """Device block split: same contract as blocks.block_split — returns
    the ascending list of block end offsets, final entry prev+in_size."""
    n = prev + in_size
    n_pad = _bucket(n)
    window = np.asarray(window, dtype=np.uint8)[:n]
    mt = np.asarray(match_table, dtype=np.int32)
    win_p = np.zeros(n_pad, np.uint8)
    win_p[:n] = window
    rl = np.zeros(n_pad, np.int32)
    rl[:n] = mt[:n, 0, 0]
    ro = np.zeros(n_pad, np.int32)
    ro[:n] = mt[:n, 0, 1]
    rl_j, ro_j = jnp.asarray(rl), jnp.asarray(ro)
    in_cap = _input_cap(in_size)
    splits, n_splits, _, ovf = _split_kernel(
        jnp.asarray(win_p), rl_j, ro_j,
        jnp.int32(prev), jnp.int32(n), n_pad, in_cap,
        trig_cap=_trig_cap(in_cap),
    )
    if bool(ovf):
        # Exact retry: more triggers than the compact budget (degenerate
        # drift patterns) — rerun this window with every slot evaluated.
        splits, n_splits, _, _ = _split_kernel(
            jnp.asarray(win_p), rl_j, ro_j,
            jnp.int32(prev), jnp.int32(n), n_pad, in_cap, trig_cap=0,
        )
    out = [int(x) for x in np.asarray(splits[: int(n_splits)])]
    out.append(n)
    return out
