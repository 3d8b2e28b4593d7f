"""LCP-interval match finder.

Reimplements the wimlib-style LCP-interval tree match finder used by the
reference (src/matchfinder.c:49-286) with identical semantics: for each
position, up to NMATCHES_PER_OFFSET matches are reported in decreasing
length order, each giving the nearest previous occurrence at that LCP
depth, discovered through the lazy interval-ascent walk.

The data layout mirrors the reference's packed encoding so a native (C++)
fast path and this spec path are interchangeable:

* ``intervals``: first the SA, then SA+LCP packed (pos | lcp<<LCP_SHIFT),
  finally the interval tree (entry per interval index: superinterval ref,
  or visiting position | VISITED_FLAG once visited).
* ``pos_data``: per-position ref of the deepest containing interval.

This stage is sequential by nature (lazy updates); the package keeps it
on the host (Python spec here, C++ in zultra_tpu/native) while the suffix
array / PLCP stages that feed it are vectorized.
"""

from __future__ import annotations

import numpy as np

from .constants import (
    EXCL_VISITED_MASK,
    LCP_MASK,
    LCP_SHIFT,
    MAX_MATCH_SIZE,
    MAX_OFFSET,
    MIN_MATCH_SIZE,
    NMATCHES_PER_OFFSET,
    POS_MASK,
    VISITED_FLAG,
)
from .suffix import plcp_numpy, suffix_array_numpy


def build_intervals(window: np.ndarray):
    """Build the packed interval tree + per-position refs for a window.

    Returns (intervals, pos_data) as int64 numpy arrays (int64 so Python
    indexing stays overflow-free; values fit in uint32).
    """
    n = int(window.shape[0])
    sa = suffix_array_numpy(window)
    plcp = plcp_numpy(window, sa)

    # Clamp LCPs into the packed field: below MIN_MATCH_SIZE → 0, above
    # MAX_MATCH_SIZE → MAX_MATCH_SIZE (reference src/matchfinder.c:81-90).
    lcp = plcp[sa]
    lcp = np.where(lcp < MIN_MATCH_SIZE, 0, np.minimum(lcp, MAX_MATCH_SIZE))
    lcp[0] = 0
    sa_and_lcp = sa.astype(np.int64) | (lcp.astype(np.int64) << LCP_SHIFT)

    intervals = np.zeros(n, dtype=np.int64)
    pos_data = np.zeros(n + 1, dtype=np.int64)

    # Stack sweep turning SA+LCP into the interval tree
    # (reference src/matchfinder.c:98-155).
    stack = [0]
    intervals[0] = 0
    next_interval_idx = 1
    prev_pos = int(sa_and_lcp[0]) & POS_MASK

    for r in range(1, n):
        packed = int(sa_and_lcp[r])
        next_pos = packed & POS_MASK
        next_lcp = packed & LCP_MASK
        top_lcp = stack[-1] & LCP_MASK

        if next_lcp == top_lcp:
            pos_data[prev_pos] = stack[-1]
        elif next_lcp > top_lcp:
            stack.append(next_lcp | next_interval_idx)
            next_interval_idx += 1
            pos_data[prev_pos] = stack[-1]
        else:
            pos_data[prev_pos] = stack[-1]
            while True:
                closed_idx = stack.pop() & POS_MASK
                super_lcp = stack[-1] & LCP_MASK
                if next_lcp == super_lcp:
                    intervals[closed_idx] = stack[-1]
                    break
                elif next_lcp > super_lcp:
                    stack.append(next_lcp | next_interval_idx)
                    next_interval_idx += 1
                    intervals[closed_idx] = stack[-1]
                    break
                else:
                    intervals[closed_idx] = stack[-1]
        prev_pos = next_pos

    pos_data[prev_pos] = stack[-1]
    while len(stack) > 1:
        top = stack.pop()
        intervals[top & POS_MASK] = stack[-1]

    return intervals, pos_data


class MatchFinder:
    """Stateful per-window match finder (positions must be visited in
    strictly increasing order, exactly as the reference does)."""

    def __init__(self, window: np.ndarray):
        self.intervals, self.pos_data = build_intervals(window)

    def matches_at(self, pos: int, max_matches: int):
        """Lazy interval-ascent walk (reference src/matchfinder.c:171-234).
        Returns a list of (length, offset) tuples, longest first."""
        intervals = self.intervals
        pos_data = self.pos_data

        ref = int(pos_data[pos])
        pos_data[pos] = 0

        # Ascend to the closest visited ancestor (or the root), marking
        # everything on the way as visited by this position.
        while True:
            super_ref = int(intervals[ref & POS_MASK])
            if not (super_ref & LCP_MASK):
                break
            intervals[ref & POS_MASK] = pos | VISITED_FLAG
            ref = super_ref

        if super_ref == 0:
            # Root, or an unvisited child of the root: no prior occurrence.
            if ref != 0:
                intervals[ref & POS_MASK] = pos | VISITED_FLAG
            return []

        match_pos = super_ref & EXCL_VISITED_MASK
        out = []
        while True:
            # Chase pos_data links to the nearest prior position whose
            # parked interval is not deeper than ours.
            while True:
                super_ref = int(pos_data[match_pos])
                if super_ref <= ref:
                    break
                match_pos = int(intervals[super_ref & POS_MASK]) & EXCL_VISITED_MASK

            intervals[ref & POS_MASK] = pos | VISITED_FLAG
            pos_data[match_pos] = ref

            if len(out) < max_matches:
                offset = pos - match_pos
                if offset <= MAX_OFFSET:
                    out.append((ref >> LCP_SHIFT, offset))

            if super_ref == 0:
                break
            ref = super_ref
            match_pos = int(intervals[ref & POS_MASK]) & EXCL_VISITED_MASK

        return out

    def skip(self, start: int, end: int) -> None:
        """Warm the lazy structures over already-compressed history bytes
        without recording matches (reference src/matchfinder.c:243-252)."""
        for i in range(start, end):
            self.matches_at(i, 0)


def find_all_matches(window: np.ndarray, start: int, end: int) -> np.ndarray:
    """Full per-window match table: shape (end, NMATCHES_PER_OFFSET, 2)
    int32 array of (length, offset), zero-padded, with lengths clamped to
    the window end (reference src/matchfinder.c:262-286).

    ``start`` is the number of history bytes (skipped through the finder),
    ``end`` the total window size.
    """
    finder = MatchFinder(window)
    finder.skip(0, start)

    table = np.zeros((end, NMATCHES_PER_OFFSET, 2), dtype=np.int32)
    for i in range(start, end):
        found = finder.matches_at(i, NMATCHES_PER_OFFSET)
        max_len = max(end - i, 0)
        for m, (length, offset) in enumerate(found):
            table[i, m, 0] = min(length, max_len)
            table[i, m, 1] = offset
    return table
