"""Device match finder: the nearest-occurrence LCP staircase computed with
device-wide sorts and scans — no sequential interval walk.

Replaces the semantics of the reference's lazy LCP-interval walk
(reference src/matchfinder.c:171-234) with the construction validated in
round 1 (tests/test_suffix.py::test_interval_centric_construction_equals_walk):
for each position p, the match list equals the *staircase* of previous
occurrences — scanning j = p-1 down, report every j whose clamped
lcp(p, j) strictly exceeds all nearer lcps (longest first, ≤8 reported,
offsets ≤ 32768). Equivalently, per ancestor LCP-interval I of p's suffix,
the within-interval predecessor pred_I(p) = max{j ∈ members(I), j < p};
rows are the breakpoints where pred strictly increases.

Device algorithm (one jit, static shapes, NO sequential loop anywhere):
  1. suffix array + rank tables        — prefix doubling (ops.suffix_jax)
  2. adjacent LCP array L[r], clamped  — rank-table descent, vectorized
  3. interval nodes                    — every boundary t with L[t] ≥ 3
     names the interval at value v=L[t] spanning it; its rank range
     [a, b) comes from two threshold PSV/NSV binary descents over a
     sparse-min table of L (one batch, no stack); duplicate (a, v) keys
     (equal-L runs inside one interval) are deduped by a sort
  4. memberships (interval, position)  — each node expands to its whole
     rank range in parallel: exclusive cumsum of sizes → flat offsets,
     scatter node ids at starts, forward-fill with a running max
  5. within-interval predecessors      — ONE lexicographic device sort by
     (interval, position): each entry's predecessor is its sorted neighbor
  6. staircase dedupe                  — second sort by (position, value
     descending) + segmented exclusive running-max scan; emit where pred
     strictly increases; cap 8 appended rows, offsets ≤ MAX_OFFSET

Degenerate inputs (long single-byte runs: interval chains up to 256 deep)
overflow the membership budget; the kernel detects this and the wrapper
falls back to the host walk FOR THAT SEGMENT ONLY — output parity is
unconditional, the device path covers realistic data (measured membership
density: text ≈ 5-9 per position, LZ-heavy fuzz data ≈ 34-49, all-zeros
254 — see docs/ARCHITECTURE.md).

Windows are cut into segments with a 32 KB history halo and a 258-byte
tail. This is exact, not approximate: a reported row (l, o) with o ≤ 32768
depends only on candidates within (p-32768, p) — farther candidates never
shadow nearer ones in the staircase — and clamped lcps only need 258 bytes
of lookahead. Segments fill a 2^17 buffer (halo + ~96 KiB core + tail) and
batch through chunked vmaps of one compiled kernel shape.

The kernel is built from sorts, scans and gathers only: the doubling SA
uses sorts, interval bounds descend a zero-padded sparse-min table at
one row-gather per level, membership expansion packs its node payload
into a single gather, and all segmented counts are scans.
"""

from __future__ import annotations

import functools
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..constants import (
    MAX_MATCH_SIZE,
    MAX_OFFSET,
    MIN_MATCH_SIZE,
    NMATCHES_PER_OFFSET,
)
from .suffix_jax import _doubling_rounds, _num_levels

HALO = MAX_OFFSET  # 32768 history bytes make segment staircases exact
TAIL = MAX_MATCH_SIZE  # 258 lookahead bytes make clamped lcps exact
# Positions resolved per segment, sized so HALO + core + TAIL fills the
# 2^17 kernel bucket exactly: the halo is pure overhead, so a fuller
# bucket is a ~1.5x throughput win over a 64 KiB core at equal kernel cost.
SEG_CORE = (1 << 17) - HALO - TAIL

# Membership budget per position (measured density: text ≈ 5-9, LZ-heavy
# fuzz data ≈ 34-49, all-zeros 254). Segments that overflow the first
# budget fall back to the host walk — degenerate runs are exactly the
# inputs the sequential walk handles in microseconds, so retrying at a
# larger budget buys nothing. Override: ZULTRA_JAX_MF_BUDGET="24".
BUDGET_LADDER = tuple(
    int(x) for x in os.environ.get("ZULTRA_JAX_MF_BUDGET", "16").split(",")
)


def _adjacent_lcp(sa: jnp.ndarray, ranks: jnp.ndarray, n: int) -> jnp.ndarray:
    """lcp(SA[r-1], SA[r]) for r in 1..n-1 via the doubling rank tables."""
    i_pos = sa[1:]
    j_pos = sa[:-1]
    lcp = jnp.zeros(n - 1, dtype=jnp.int32)
    levels = ranks.shape[0] - 1

    def body(carry, level_rank_and_width):
        lcp = carry
        level_rank, width = level_rank_and_width
        ia = i_pos + lcp
        ja = j_pos + lcp
        ok = (ia + width <= n) & (ja + width <= n)
        ra = level_rank[jnp.clip(ia, 0, n - 1)]
        rb = level_rank[jnp.clip(ja, 0, n - 1)]
        lcp = jnp.where(ok & (ra == rb), lcp + width, lcp)
        return lcp, None

    widths = jnp.array([1 << l for l in range(levels, -1, -1)], dtype=jnp.int32)
    lcp, _ = lax.scan(body, lcp, (ranks[::-1], widths))
    return lcp


def _build_sparse_min(a: jnp.ndarray, levels: int) -> jnp.ndarray:
    """st[l][i] = min(a[i .. i+2^l-1]), windows clipped at the end."""
    big = a.dtype.type(2**30)
    tables = [a]
    cur = a
    for l in range(1, levels + 1):
        k = 1 << (l - 1)
        shifted = jnp.concatenate([cur[k:], jnp.full((k,), big, cur.dtype)])
        cur = jnp.minimum(cur, shifted)
        tables.append(cur)
    return jnp.stack(tables)


def _find_left(st: jnp.ndarray, lev: int, pad: int, x, t):
    """Largest a ≤ x with L[a] < t (exists: L[0] = 0 < t).

    Single top-down descent of the zero-padded sparse-min table ``st``
    built over [zeros(pad) | L | zeros(pad)] with pad = 2^lev ≥ len(L):
    the window [x+1-2^lev, x] always covers position 0, the left padding
    makes its start index non-negative without per-element clipping, and
    each level needs ONE row gather. Rightmost preference: take
    the right half whenever it still contains a value < t; real positions
    lie right of the padding, so the result is never a pad index."""
    cur = x + 1  # padded coord of the window start: pad + x + 1 - 2^lev
    for l in range(lev - 1, -1, -1):
        right_min = st[l][cur + (1 << l)]
        cur = jnp.where(right_min < t, cur + (1 << l), cur)
    return cur - pad


def _find_right(st: jnp.ndarray, lev: int, pad: int, x, t):
    """Smallest b ≥ x with L[b] < t (exists: sentinel L[m-1] = 0).

    Mirror of _find_left over the same padded table: window [x, x+2^lev),
    leftmost preference, right padding keeps indices in bounds; the real
    sentinel L[m-1] = 0 lies left of the padding, so the result is never
    a pad index."""
    cur = pad + x
    for l in range(lev - 1, -1, -1):
        left_min = st[l][cur]
        cur = jnp.where(left_min < t, cur, cur + (1 << l))
    return cur - pad


def _prev_in_segment(values: jnp.ndarray, seg_id: jnp.ndarray) -> jnp.ndarray:
    """The previous entry's value within the same segment (-1 at segment
    starts). Sufficient for the staircase dedupe because within-interval
    predecessors are monotone non-decreasing along each chain (member sets
    nest), so the previous value IS the running maximum."""
    neg = jnp.int32(-1)
    shifted_vals = jnp.concatenate([jnp.full((1,), neg), values[:-1]])
    shifted_seg = jnp.concatenate([jnp.full((1,), jnp.int32(-1)), seg_id[:-1]])
    return jnp.where(shifted_seg == seg_id, shifted_vals, neg)


@functools.partial(jax.jit, static_argnames=("n", "budget_factor"))
def _staircase_kernel(data: jnp.ndarray, n: int, budget_factor: int):
    """data: (n,) int32 — bytes 0..255 plus unique sentinel values ≥ 256
    for padding (each sentinel occurs once, so padded suffixes share no
    prefix with anything). Returns (lens (n,8), offs (n,8), overflow)."""
    levels = _num_levels(n)
    # Store only the rank tables for widths 1..256: lcps are clamped at
    # MAX_MATCH_SIZE (258 ≤ 256+128+...+1), so the descent in
    # _adjacent_lcp never needs a wider gram table, and halving the rows
    # halves its gather count. Rounds past the stored ones early-exit
    # once ranks are distinct.
    sa, ranks = _doubling_rounds(data, n, levels, store_levels=8)
    pos = sa  # pos[r] = position of rank r

    # L_arr[r] = clamped lcp between ranks r-1, r; L_arr[0] = L_arr[n] = 0.
    raw = _adjacent_lcp(sa, ranks, n)
    clamped = jnp.where(raw < MIN_MATCH_SIZE, 0, jnp.minimum(raw, MAX_MATCH_SIZE))
    L_arr = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), clamped.astype(jnp.int32), jnp.zeros(1, jnp.int32)]
    )  # length n+1, sentinel at n
    m = n + 1
    lev_L = max(1, int(math.ceil(math.log2(m))))
    pad = 1 << lev_L
    padded = jnp.concatenate(
        [jnp.zeros(pad, jnp.int32), L_arr, jnp.zeros(pad, jnp.int32)]
    )
    st = _build_sparse_min(padded, lev_L)

    # --- interval nodes: one candidate per boundary t with L[t] ≥ 3 ------
    t_idx = jnp.arange(n, dtype=jnp.int32)  # boundaries 0..n-1 (0 invalid)
    v_t = L_arr[:n]
    valid_t = v_t > 0
    thresh = jnp.maximum(v_t, 1)
    a_t = _find_left(st, lev_L, pad, jnp.maximum(t_idx - 1, 0), thresh)
    b_t = _find_right(st, lev_L, pad, t_idx + 1, thresh)

    # Dedupe boundaries naming the same interval (equal-L runs): sort by
    # (a*512+v) and keep first occurrences, then restore boundary order so
    # cumsum offsets stay monotone in node id.
    key_t = jnp.where(valid_t, a_t * 512 + v_t, jnp.int32(2**30))
    key_sorted, t_sorted = lax.sort((key_t, t_idx), num_keys=2)
    first = jnp.concatenate(
        [jnp.ones(1, jnp.bool_), key_sorted[1:] != key_sorted[:-1]]
    ) & (key_sorted < 2**30)
    is_node = jnp.zeros(n, jnp.bool_).at[t_sorted].set(first)

    sizes = jnp.where(is_node, b_t - a_t, 0)
    cum = jnp.cumsum(sizes) - sizes  # exclusive: node t's entries start here
    total = cum[-1] + sizes[-1]
    cap = budget_factor * n
    overflow = total > cap

    # --- expand memberships: scatter node ids at starts, forward-fill ----
    # Two gathers total (packed node payload + SA), everything else scans.
    arange_cap = jnp.arange(cap, dtype=jnp.int32)
    starts = jnp.where(is_node & (sizes > 0) & ~overflow, cum, cap)
    node_at = jnp.full(cap, jnp.int32(-1)).at[starts].max(t_idx, mode="drop")
    mem_node = lax.cummax(node_at)  # node ids ascend with their offsets
    in_use = (arange_cap < total) & (mem_node >= 0) & ~overflow
    safe_node = jnp.maximum(mem_node, 0)
    # Offset within the run from a scan (valid t is ≥ 1, so node_at ≥ 0
    # exactly at run starts), replacing the cum[safe_node] gather.
    run_start = lax.cummax(jnp.where(node_at >= 0, arange_cap, 0))
    pav = a_t * 512 + v_t  # a_t < n ≤ 2^21, v_t ≤ 258 < 2^9
    pav_e = pav[safe_node]
    rank_e = (pav_e >> 9) + (arange_cap - run_start)
    pos_e = pos[jnp.clip(rank_e, 0, n - 1)]
    val_e = pav_e & 511

    # Sort 1: (interval, position) → within-interval predecessor.
    key1 = jnp.where(in_use, mem_node, jnp.int32(2**30))
    pv = jnp.where(in_use, pos_e * 512 + (511 - val_e), jnp.int32(2**30))
    k_sorted, pv_sorted = lax.sort((key1, pv), num_keys=2)
    prev_same = jnp.concatenate(
        [jnp.zeros(1, jnp.bool_), k_sorted[1:] == k_sorted[:-1]]
    )
    prev_pos = jnp.concatenate([jnp.full((1,), jnp.int32(-1)), pv_sorted[:-1] >> 9])
    pred = jnp.where(prev_same & (k_sorted < 2**30), prev_pos, jnp.int32(-1))

    # Sort 2: (position, value descending) = chain order, deepest first.
    pv2, pred2 = lax.sort((pv_sorted, pred), num_keys=1)
    p2 = pv2 >> 9
    val2 = 511 - (pv2 & 511)

    # Staircase dedupe: emit where pred strictly exceeds every earlier
    # (deeper) pred in the chain; append (≤8 rows) only when offset fits.
    last = _prev_in_segment(pred2, p2)
    emit = (pred2 > last) & (pred2 >= 0) & (pv2 < 2**30)
    offs = p2 - pred2
    append = emit & (offs <= MAX_OFFSET)

    # Segmented cumulative count of appended rows, gather-free: the
    # exclusive global count at each segment start is non-decreasing
    # across segments, so forward-filling it is a running max.
    seg_first = jnp.concatenate(
        [jnp.ones(1, jnp.bool_), p2[1:] != p2[:-1]]
    )
    app_i = append.astype(jnp.int32)
    csum = jnp.cumsum(app_i)
    base = lax.cummax(jnp.where(seg_first, csum - app_i, 0))
    inc_count = csum - base
    row = inc_count - 1  # 0-based slot among appended rows
    write = append & (row < NMATCHES_PER_OFFSET)
    flat = jnp.where(write, p2 * NMATCHES_PER_OFFSET + row, n * NMATCHES_PER_OFFSET)

    # One packed scatter ((len << 16) | off — len ≤ 258, off ≤ 32768)
    # instead of two.
    packed = jnp.zeros(n * NMATCHES_PER_OFFSET, jnp.int32).at[flat].set(
        (val2 << 16) | offs, mode="drop"
    )
    return (
        (packed >> 16).reshape(n, NMATCHES_PER_OFFSET),
        (packed & 0xFFFF).reshape(n, NMATCHES_PER_OFFSET),
        overflow,
    )


def _bucket(n: int) -> int:
    """Static kernel sizes: few distinct shapes → few compiles."""
    size = 4096
    while size < n:
        size *= 2
    return size


# ---------------------------------------------------------------------------
# Batched / mesh-sharded segment processing: uniform buffer layout
# [ HALO history | core | TAIL ], core always at offset ``halo`` — missing
# history or tail (window edges) is filled with unique sentinels, which is
# exactly the no-candidates semantics of the window edge.
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("n", "budget_factor", "core_off", "core_len"))
def _core_kernel(data, n, budget_factor, core_off: int, core_len: int):
    lens, offs, overflow = _staircase_kernel(data, n, budget_factor)
    sl = slice(core_off, core_off + core_len)
    # uint16 outputs (lens ≤ 258, offs ≤ 32768) halve the device→host
    # transfer.
    return lens[sl].astype(jnp.uint16), offs[sl].astype(jnp.uint16), overflow


@functools.partial(jax.jit, static_argnames=("n", "budget_factor", "core_off", "core_len"))
def _chunk_kernel(bufs, n, budget_factor, core_off: int, core_len: int):
    """Batched segment kernel. Module-level jit (NOT a per-call closure):
    the executable is cached across calls by (shape, statics) — a fresh
    jit(vmap(closure)) per call would recompile every invocation."""
    return jax.vmap(
        lambda b: _core_kernel(b, n, budget_factor, core_off, core_len)
    )(bufs)


@functools.lru_cache(maxsize=None)
def _sharded_chunk_fn(mesh, n, budget_factor, core_off: int, core_len: int):
    """Jitted shard_map of the segment kernel over BOTH mesh axes: the
    flat segment axis is laid out window-major (build_segments), so 'dp'
    carries window groups and 'sp' carries segments WITHIN a window —
    bytes-within-window sharding in compression proper, not just the
    stats step. Cached by (mesh, statics) so repeated corpus calls reuse
    the executable instead of recompiling."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    step = shard_map(
        jax.vmap(lambda b: _core_kernel(b, n, budget_factor, core_off, core_len)),
        mesh=mesh, in_specs=P(("dp", "sp")), out_specs=P(("dp", "sp")),
        check_vma=False,
    )
    return jax.jit(step)


def build_segments(data: np.ndarray, spans, seg_core: int):
    """Cut the corpus into per-window segments with the uniform layout.

    ``spans``: the stream's window byte ranges [(lo, hi), ...] — matches
    may reach 32 KB back INTO the previous window (the history slide) but
    never beyond the current window's start-of-buffer, and lcps clamp at
    the window end, exactly like the streaming core.

    Returns (segbufs (S, L) int32, metas) with L = HALO + seg_core + TAIL
    and metas[s] = (window_index, core_lo_abs, core_len).
    """
    L = HALO + seg_core + TAIL
    bufs = []
    metas = []
    n_total = data.shape[0]
    for w, (w_lo, w_hi) in enumerate(spans):
        prev = min(HALO, w_lo)
        buf_start_abs = w_lo - prev  # window buffer start in corpus coords
        core = w_lo
        while core < w_hi:
            core_hi = min(core + seg_core, w_hi)
            lo = max(core - HALO, buf_start_abs)
            hi = min(core_hi + TAIL, w_hi)  # lcps clamp at the window end
            buf = np.empty(L, dtype=np.int32)
            # Unique sentinels everywhere, real bytes in the middle.
            buf[:] = 256 + np.arange(L, dtype=np.int32)
            dst = HALO - (core - lo)
            buf[dst : dst + (hi - lo)] = data[lo:hi]
            bufs.append(buf)
            metas.append((w, core, core_hi - core))
            core = core_hi
    return np.stack(bufs), metas


# vmap width per dispatch: the local path loops jit(vmap(kernel)) over
# fixed-size chunks of segments (one compiled shape), which bounds the
# memory one dispatch holds however many segments a corpus has.
VMAP_CHUNK = 8
# Segments per device per dispatch on a mesh (~64 MB of device scratch
# each at the default segment size).
MESH_CHUNK = 32


def match_tables_for_spans(
    data: np.ndarray,
    spans,
    seg_core: int | None = None,
    budget_factor: int = 16,
    mesh=None,
) -> list[np.ndarray]:
    """Per-window match tables for the stream's window spans, computed as
    batched segment kernels — locally as chunked vmaps, or with shard_map
    over every device of ``mesh`` when it is given.
    Overflowing segments (degenerate runs) fall back to the host walk.
    Returns one (prev+in_size, 8, 2) int32 table per window."""
    import jax
    import jax.numpy as jnp

    if seg_core is None:
        seg_core = SEG_CORE

    data = np.asarray(data, dtype=np.uint8)
    segbufs, metas = build_segments(data, spans, seg_core)
    S, L = segbufs.shape

    if mesh is None:
        # Dispatch ahead (JAX dispatch is async): keep a few chunks in
        # flight so device compute overlaps the device->host fetches.
        # Depth bounds resident output buffers (~25 MB/chunk at defaults).
        DEPTH = 4
        lens_c, offs_c, over_c = [], [], []
        in_flight = []

        def drain_one():
            n_real, (cl, co, cv) = in_flight.pop(0)
            lens_c.append(np.asarray(cl[:n_real]))
            offs_c.append(np.asarray(co[:n_real]))
            over_c.append(np.asarray(cv[:n_real]))

        for i in range(0, S, VMAP_CHUNK):
            chunk = segbufs[i : i + VMAP_CHUNK]
            n_real = chunk.shape[0]
            if n_real < VMAP_CHUNK:
                pad = np.broadcast_to(chunk[-1], (VMAP_CHUNK - n_real, L))
                chunk = np.concatenate([chunk, pad])
            out = _chunk_kernel(
                jnp.asarray(chunk), L, budget_factor, HALO, seg_core
            )
            in_flight.append((n_real, out))
            if len(in_flight) > DEPTH:
                drain_one()
        while in_flight:
            drain_one()
        lens = np.concatenate(lens_c)
        offs = np.concatenate(offs_c)
        over = np.concatenate(over_c)
    else:
        from jax.sharding import NamedSharding, PartitionSpec as P

        n_dev = mesh.shape["dp"] * mesh.shape["sp"]
        # At most MESH_CHUNK segments per device per dispatch: bounded
        # device memory, and one compiled shape for every large corpus.
        per = n_dev * min(MESH_CHUNK, -(-S // n_dev))
        step = _sharded_chunk_fn(mesh, L, budget_factor, HALO, seg_core)
        sharding = NamedSharding(mesh, P(("dp", "sp")))
        outs = []
        for i in range(0, S, per):
            chunk = segbufs[i : i + per]
            if chunk.shape[0] < per:
                pad = np.broadcast_to(chunk[-1], (per - chunk.shape[0], L))
                chunk = np.concatenate([chunk, pad])
            outs.append(step(jax.device_put(jnp.asarray(chunk), sharding)))
        lens, offs, over = (np.concatenate([np.asarray(o[j]) for o in outs])
                            for j in range(3))
    lens = np.asarray(lens[:S])
    offs = np.asarray(offs[:S])
    over = np.asarray(over[:S])
    FALLBACK_STATS["segments"] += S
    FALLBACK_STATS["overflowed"] += int(np.sum(over != 0))

    tables = []
    for w, (w_lo, w_hi) in enumerate(spans):
        prev = min(HALO, w_lo)
        tables.append(
            np.zeros((prev + (w_hi - w_lo), NMATCHES_PER_OFFSET, 2), dtype=np.int32)
        )
    for s, (w, core_abs, core_len) in enumerate(metas):
        w_lo, w_hi = spans[w]
        prev = min(HALO, w_lo)
        rel = core_abs - w_lo + prev  # row index inside the window buffer
        if over[s]:
            # Degenerate segment (membership budget exceeded): host walk
            # over the same clipped range — identical rows by the halo
            # equivalence.
            lo = max(core_abs - HALO, w_lo - prev)
            hi = min(core_abs + core_len + TAIL, w_hi)
            sub = _host_walk(data[lo:hi], core_abs - lo)
            tables[w][rel : rel + core_len] = sub[core_abs - lo : core_abs - lo + core_len]
        else:
            tables[w][rel : rel + core_len, :, 0] = lens[s, :core_len]
            tables[w][rel : rel + core_len, :, 1] = offs[s, :core_len]
    return tables


def _host_walk(window_bytes: np.ndarray, start: int) -> np.ndarray:
    """Host lazy-walk fallback for degenerate segments: native when built
    (microseconds for run-heavy data), spec walk otherwise."""
    try:
        from .. import native

        return native.build_match_table(
            np.ascontiguousarray(window_bytes), start
        ).astype(np.int32)
    except Exception:
        from ..matchfinder import find_all_matches

        return find_all_matches(window_bytes.copy(), start, window_bytes.shape[0])


# Host-fallback accounting: segments processed
# vs segments whose membership budget overflowed (degenerate runs that
# fell back to the host walk). Read/reset by bench.py.
FALLBACK_STATS = {"segments": 0, "overflowed": 0}


def match_table_device(
    window: np.ndarray, start: int, end: int, budget_factor: int | None = None
):
    """Device-RESIDENT per-window match table: same construction as
    ``match_table_jax`` but the (end, 8) length/offset arrays stay on the
    device (uint16) — nothing table-sized crosses the host link. Only the
    per-segment overflow flags download; overflowing segments (degenerate
    runs) are host-walked and their rows uploaded back.

    Returns (lens (end, 8) uint16 jnp, offs (end, 8) uint16 jnp). Rows
    [0, start) are zero (history positions report no matches)."""
    window = np.asarray(window, dtype=np.uint8)
    budget = budget_factor if budget_factor is not None else BUDGET_LADDER[0]
    seg_core = SEG_CORE
    segbufs, metas = build_segments(window[:end], [(start, end)], seg_core)
    S, L = segbufs.shape

    lens_c, offs_c, over_c = [], [], []
    for i in range(0, S, VMAP_CHUNK):
        chunk = segbufs[i : i + VMAP_CHUNK]
        n_real = chunk.shape[0]
        if n_real < VMAP_CHUNK:
            pad = np.broadcast_to(chunk[-1], (VMAP_CHUNK - n_real, L))
            chunk = np.concatenate([chunk, pad])
        cl, co, cv = _chunk_kernel(jnp.asarray(chunk), L, budget, HALO, seg_core)
        lens_c.append(cl[:n_real])
        offs_c.append(co[:n_real])
        over_c.append(cv[:n_real])

    # (S * seg_core, 8) device arrays; segment cores are consecutive
    # window ranges, so concatenation IS the window layout.
    lens_flat = jnp.concatenate(lens_c).reshape(-1, NMATCHES_PER_OFFSET)
    offs_flat = jnp.concatenate(offs_c).reshape(-1, NMATCHES_PER_OFFSET)
    in_size = end - start
    head = jnp.zeros((start, NMATCHES_PER_OFFSET), jnp.uint16)
    lens = jnp.concatenate([head, lens_flat[:in_size]])
    offs = jnp.concatenate([head, offs_flat[:in_size]])

    over = np.asarray(jnp.concatenate(over_c))  # tiny download
    FALLBACK_STATS["segments"] += S
    FALLBACK_STATS["overflowed"] += int(np.sum(over != 0))
    for s, (_, core_abs, core_len) in enumerate(metas):
        if not over[s]:
            continue
        lo = max(core_abs - HALO, 0)
        hi = min(core_abs + core_len + TAIL, end)
        sub = _host_walk(window[lo:hi], core_abs - lo)
        rows = sub[core_abs - lo : core_abs - lo + core_len]
        lens = lax.dynamic_update_slice(
            lens, jnp.asarray(rows[:, :, 0].astype(np.uint16)), (core_abs, 0)
        )
        offs = lax.dynamic_update_slice(
            offs, jnp.asarray(rows[:, :, 1].astype(np.uint16)), (core_abs, 0)
        )
    return lens, offs


@functools.partial(jax.jit, static_argnames=("W", "k", "seg_core", "mbs"))
def _assemble_stacked(lens_all, offs_all, in_sizes, W: int, k: int,
                      seg_core: int, mbs: int):
    """(W*k, seg_core, 8) chunk outputs → (W, HALO+mbs, 8) window lanes.

    Segment cores tile each window contiguously, so per-window rows are a
    pure reshape; rows past each window's in_size (garbage from the last
    partial segment) zero out, and HALO zero rows are prepended (history
    positions report no matches — the lane layout every consumer of the
    stacked tables assumes)."""
    def shape(x):
        x = x.reshape(W, k * seg_core, NMATCHES_PER_OFFSET)[:, :mbs]
        row = jnp.arange(mbs, dtype=jnp.int32)[None, :, None]
        x = jnp.where(row < in_sizes[:, None, None], x, 0)
        head = jnp.zeros((W, HALO, NMATCHES_PER_OFFSET), jnp.uint16)
        return jnp.concatenate([head, x], axis=1)

    return shape(lens_all), shape(offs_all)


def match_tables_device_stacked(corpus: np.ndarray, spans, mbs: int,
                                budget_factor: int | None = None, mesh=None):
    """Device-RESIDENT match tables for a BATCH of window spans, stacked
    into one uniform lane layout: returns (lens, offs) of shape
    (W, HALO+mbs, 8) uint16 where lane w's rows [HALO, HALO+in_size_w)
    are window w's input positions (in_size_w = hi-lo of spans[w]; every
    span but the last must be exactly ``mbs`` long) and all other rows
    are zero. Nothing table-sized crosses the host link; overflowing
    (degenerate-run) segments are host-walked and patched back
    (FALLBACK_STATS accounting).

    This is the batched begin-phase form: all windows' segments run
    through full-occupancy kernel chunks, so per-window chunk under-fill
    disappears and the downstream batched splitter/planner amortize their
    serial scan latency across the whole window batch."""
    corpus = np.asarray(corpus, dtype=np.uint8)
    budget = budget_factor if budget_factor is not None else BUDGET_LADDER[0]
    seg_core = SEG_CORE
    W = len(spans)
    k = -(-mbs // seg_core)
    for w_lo, w_hi in spans[:-1]:
        assert w_hi - w_lo == mbs, "only the last span may be partial"
    segbufs, metas = build_segments(corpus, spans, seg_core)
    S, L = segbufs.shape

    if mesh is None:
        lens_c, offs_c, over_c = [], [], []
        for i in range(0, S, VMAP_CHUNK):
            chunk = segbufs[i : i + VMAP_CHUNK]
            n_real = chunk.shape[0]
            if n_real < VMAP_CHUNK:
                pad = np.broadcast_to(chunk[-1], (VMAP_CHUNK - n_real, L))
                chunk = np.concatenate([chunk, pad])
            cl, co, cv = _chunk_kernel(jnp.asarray(chunk), L, budget, HALO, seg_core)
            lens_c.append(cl[:n_real])
            offs_c.append(co[:n_real])
            over_c.append(cv[:n_real])
        lens_all = jnp.concatenate(lens_c)[:S]
        offs_all = jnp.concatenate(offs_c)[:S]
        over_c = [jnp.concatenate(over_c)[:S]]
    else:
        from jax.sharding import NamedSharding, PartitionSpec as P

        n_dev = mesh.shape["dp"] * mesh.shape["sp"]
        S_pad = -(-S // n_dev) * n_dev
        bufs = segbufs
        if S_pad > S:
            pad = np.broadcast_to(bufs[-1], (S_pad - S, L))
            bufs = np.concatenate([bufs, pad])
        step = _sharded_chunk_fn(mesh, L, budget, HALO, seg_core)
        arr = jax.device_put(jnp.asarray(bufs), NamedSharding(mesh, P(("dp", "sp"))))
        lens_all, offs_all, over_all = step(arr)
        lens_all = lens_all[:S]
        offs_all = offs_all[:S]
        over_c = [over_all[:S]]
    pad_lanes = W * k - S  # the last window's missing segments
    if pad_lanes:
        z = jnp.zeros((pad_lanes, seg_core, NMATCHES_PER_OFFSET), jnp.uint16)
        lens_all = jnp.concatenate([lens_all, z])
        offs_all = jnp.concatenate([offs_all, z])
    in_sizes = jnp.asarray(
        np.array([hi - lo for lo, hi in spans], dtype=np.int32)
    )
    lens_st, offs_st = _assemble_stacked(
        lens_all, offs_all, in_sizes, W, k, seg_core, mbs
    )

    over = np.asarray(jnp.concatenate(over_c))  # tiny download
    FALLBACK_STATS["segments"] += S
    FALLBACK_STATS["overflowed"] += int(np.sum(over != 0))
    for s, (w, core_abs, core_len) in enumerate(metas):
        if not over[s]:
            continue
        w_lo, w_hi = spans[w]
        prev = min(HALO, w_lo)
        lo = max(core_abs - HALO, w_lo - prev)
        hi = min(core_abs + core_len + TAIL, w_hi)
        sub = _host_walk(corpus[lo:hi], core_abs - lo)
        rows = sub[core_abs - lo : core_abs - lo + core_len]
        at = (jnp.int32(w), jnp.int32(HALO + core_abs - w_lo), jnp.int32(0))
        lens_st = lax.dynamic_update_slice(
            lens_st, jnp.asarray(rows[:, :, 0].astype(np.uint16))[None], at
        )
        offs_st = lax.dynamic_update_slice(
            offs_st, jnp.asarray(rows[:, :, 1].astype(np.uint16))[None], at
        )
    return lens_st, offs_st


def match_table_jax(
    window: np.ndarray, start: int, end: int, budget_factor: int | None = None
) -> np.ndarray:
    """Full per-window match table, shape (end, 8, 2) int32 of
    (length, offset) — bit-identical to matchfinder.find_all_matches.

    ``start``: history bytes (no rows reported, usable as predecessors,
    at most HALO of them — the streaming core never carries more);
    ``end``: total window size. The window runs through the same chunked
    batched segment kernels as the corpus path (one span)."""
    window = np.asarray(window, dtype=np.uint8)
    if start > HALO:
        # More history than DEFLATE can reference — not produced by the
        # streaming core; walk it on the host.
        return _host_walk(window[:end], start)
    budget = budget_factor if budget_factor is not None else BUDGET_LADDER[0]
    [table] = match_tables_for_spans(
        window[:end], [(start, end)], budget_factor=budget
    )
    return table
