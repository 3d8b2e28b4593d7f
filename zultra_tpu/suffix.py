"""Suffix array and LCP construction.

The reference derives its match finder from a suffix array built by
libdivsufsort (reference src/libdivsufsort/) followed by a permuted-LCP
(Kärkkäinen Φ) pass and a clamp into the packed SA+LCP encoding
(reference src/matchfinder.c:49-90).

A suffix array is canonical — every correct construction algorithm yields
the identical permutation — so this module is free to use data-parallel
algorithms instead of divsufsort's recursive induced sort:

* ``suffix_array_numpy``: prefix-doubling with ``np.lexsort`` (the host
  spec path, O(n log² n) but fully vectorized).
* a JAX prefix-doubling variant lives in ``zultra_tpu.ops``.

The PLCP array is likewise uniquely defined; ``plcp_numpy`` computes it
with a vectorized batch-doubling comparison instead of the sequential
Φ walk.
"""

from __future__ import annotations

import numpy as np


def suffix_array_numpy(data: np.ndarray) -> np.ndarray:
    """Suffix array via prefix doubling (Manber–Myers with lexsort).

    ``data``: uint8 array. Returns int32 array ``sa`` with the indices of
    the sorted suffixes. Matches divsufsort output exactly (the suffix
    array of a string is unique).
    """
    n = int(data.shape[0])
    if n == 0:
        return np.empty(0, dtype=np.int32)
    if n == 1:
        return np.zeros(1, dtype=np.int32)

    rank = data.astype(np.int32)
    sa = np.argsort(rank, kind="stable").astype(np.int32)
    # Re-rank after the first character sort.
    sorted_ranks = rank[sa]
    new_rank = np.empty(n, dtype=np.int32)
    diff = np.concatenate(([0], (sorted_ranks[1:] != sorted_ranks[:-1]).astype(np.int32)))
    new_rank[sa] = np.cumsum(diff)
    rank = new_rank

    k = 1
    while k < n:
        if rank[sa[-1]] == n - 1:
            break  # all ranks distinct
        # Sort by (rank[i], rank[i+k]) with rank[i+k] = -1 past the end.
        rank2 = np.full(n, -1, dtype=np.int64)
        rank2[: n - k] = rank[k:]
        sa = np.lexsort((rank2, rank)).astype(np.int32)
        key1 = rank[sa]
        key2 = rank2[sa]
        diff = np.concatenate(
            ([0], ((key1[1:] != key1[:-1]) | (key2[1:] != key2[:-1])).astype(np.int32))
        )
        new_rank = np.empty(n, dtype=np.int32)
        new_rank[sa] = np.cumsum(diff)
        rank = new_rank
        k <<= 1

    return sa


def plcp_numpy(data: np.ndarray, sa: np.ndarray) -> np.ndarray:
    """Permuted LCP: plcp[i] = lcp(suffix i, suffix Φ(i)) where Φ(i) is the
    suffix preceding i in the suffix array (Φ of the SA's first entry is
    undefined → plcp = 0, reference src/matchfinder.c:62-76).

    Vectorized: start from the Φ pairs and extend all unresolved pairs by
    doubling comparison windows. Total work O(n log n) worst case but the
    constant is small and every step is a flat vector op.
    """
    n = int(data.shape[0])
    plcp = np.zeros(n, dtype=np.int32)
    if n < 2:
        return plcp

    phi = np.empty(n, dtype=np.int64)
    phi[sa[1:]] = sa[:-1]
    root = int(sa[0])

    idx = np.arange(n, dtype=np.int64)
    mask = idx != root
    i_pos = idx[mask]
    j_pos = phi[mask]

    lcp = np.zeros(i_pos.shape[0], dtype=np.int64)
    active = np.arange(i_pos.shape[0], dtype=np.int64)

    # Extend by exponentially growing chunks: compare data[i+l : i+l+c] with
    # data[j+l : j+l+c]; fully-equal chunks extend l by c, others finish via
    # a first-mismatch scan inside the chunk.
    chunk = 16
    data64 = data.astype(np.uint8)
    while active.size:
        ia = i_pos[active]
        ja = j_pos[active]
        la = lcp[active]
        remaining = n - np.maximum(ia, ja) - la
        c = min(chunk, 1 << 20)
        # Gather the comparison windows (clipped; out-of-range treated as
        # mismatch via the remaining-length cap).
        span = np.arange(c, dtype=np.int64)
        ai = np.minimum(ia[:, None] + la[:, None] + span[None, :], n - 1)
        bi = np.minimum(ja[:, None] + la[:, None] + span[None, :], n - 1)
        eq = data64[ai] == data64[bi]
        # Positions beyond the shorter suffix's end are mismatches.
        eq &= span[None, :] < remaining[:, None]
        # Count of leading equal positions inside the chunk.
        first_neq = np.where(eq.all(axis=1), c, np.argmin(eq, axis=1))
        lcp[active] = la + first_neq
        still = first_neq == c
        active = active[still]
        chunk = min(chunk * 2, 4096)

    plcp[i_pos] = lcp.astype(np.int32)
    return plcp


def suffix_array_ref(data: bytes) -> np.ndarray:
    """O(n² log n) oracle for unit tests on tiny inputs."""
    n = len(data)
    order = sorted(range(n), key=lambda i: data[i:])
    return np.array(order, dtype=np.int32)
