"""DEFLATE bitstream format constants and symbol-mapping tables.

Reimplementation of the format layer of the reference
(see reference src/format.h:37-51 and src/blockdeflate.c:45-85).
The symbol-mapping tables are *generated* from the RFC 1951 code tables
rather than transcribed.

All tables are plain NumPy arrays so they can be used from host code and
captured as constants inside jitted JAX computations alike.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Core format constants (RFC 1951; reference src/format.h)
# ---------------------------------------------------------------------------

MIN_MATCH_SIZE = 3
MAX_MATCH_SIZE = 258
MIN_OFFSET = 1
MAX_OFFSET = 32768
HISTORY_SIZE = 0x8000

NCODELENBITS = 3          # bits per raw code-length-table entry
NCODELENSYMS = 19         # code-length alphabet size
NLITERALSYMS = 288        # literal/length alphabet size (incl. 2 invalid)
NVALIDLITERALSYMS = 286
NEODMARKERSYM = 256       # end-of-data marker symbol
NMATCHLENSYMSTART = 257   # first match-length symbol
NMATCHLENSYMS = 29
NOFFSETSYMS = 32          # offset alphabet size (incl. 2 invalid)
NVALIDOFFSETSYMS = 30

MAX_SYMBOLS = 288         # largest alphabet an encoder handles
MAX_CODES_MASK = 31       # RLE code-enable mask search space

# Tuning constants (reference src/private.h:41-56)
LCP_BITS = 9
LCP_MAX = (1 << LCP_BITS) - 1
LCP_SHIFT = 31 - LCP_BITS
LCP_MASK = LCP_MAX << LCP_SHIFT
POS_MASK = (1 << LCP_SHIFT) - 1
VISITED_FLAG = 0x80000000
EXCL_VISITED_MASK = 0x7FFFFFFF

NMATCHES_PER_OFFSET = 8
LEAVE_ALONE_MATCH_SIZE = 40
LAST_LITERALS = 0
MAX_SPLITS = 64

DEFAULT_MAX_BLOCK_SIZE = 1048576
MIN_BLOCK_SIZE_LIMIT = 32768
MAX_BLOCK_SIZE_LIMIT = 2097152

# Container framing flags (reference src/libzultra.h:64-66)
FLAG_DEFLATE_FRAMING = 0
FLAG_ZLIB_FRAMING = 1
FLAG_GZIP_FRAMING = 2

# Code-lengths table symbol transmission order (RFC 1951 section 3.2.7)
CODELEN_SYM_ORDER = np.array(
    [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15],
    dtype=np.int32,
)

# ---------------------------------------------------------------------------
# RFC 1951 section 3.2.5 code tables, from which everything is generated
# ---------------------------------------------------------------------------

# Match length codes 257..285: (extra bits, first length)
_LENGTH_CODES = [
    (0, 3), (0, 4), (0, 5), (0, 6), (0, 7), (0, 8), (0, 9), (0, 10),
    (1, 11), (1, 13), (1, 15), (1, 17),
    (2, 19), (2, 23), (2, 27), (2, 31),
    (3, 35), (3, 43), (3, 51), (3, 59),
    (4, 67), (4, 83), (4, 99), (4, 115),
    (5, 131), (5, 163), (5, 195), (5, 227),
    (0, 258),
]

# Offset (distance) codes 0..29: (extra bits, first offset)
_OFFSET_CODES = [
    (0, 1), (0, 2), (0, 3), (0, 4),
    (1, 5), (1, 7),
    (2, 9), (2, 13),
    (3, 17), (3, 25),
    (4, 33), (4, 49),
    (5, 65), (5, 97),
    (6, 129), (6, 193),
    (7, 257), (7, 385),
    (8, 513), (8, 769),
    (9, 1025), (9, 1537),
    (10, 2049), (10, 3073),
    (11, 4097), (11, 6145),
    (12, 8193), (12, 12289),
    (13, 16385), (13, 24577),
]


def _build_length_tables():
    """Map encoded match length (length - MIN_MATCH_SIZE, clamped to 255)
    to (symbol, extra bits, encoded base)."""
    sym = np.zeros(256, dtype=np.int32)
    extra = np.zeros(256, dtype=np.int32)
    base = np.zeros(256, dtype=np.int32)
    for code_idx, (ebits, first_len) in enumerate(_LENGTH_CODES):
        symbol = NMATCHLENSYMSTART + code_idx
        span = 1 << ebits
        lo = first_len - MIN_MATCH_SIZE
        for enc in range(lo, min(lo + span, 256)):
            sym[enc] = symbol
            extra[enc] = ebits
            base[enc] = lo
    # Length 258 (encoded 255) uses symbol 285 with zero extra bits.
    sym[255] = 285
    extra[255] = 0
    base[255] = 255
    return sym, extra, base


def _build_offset_tables():
    """Two-level offset mapping: indices 0..255 cover offsets 1..256
    directly (idx = offset - 1); indices 256..511 cover offsets 257..32768
    in steps of 128 (idx = 256 + ((offset - 257) >> 7)).

    Mirrors the addressing scheme of reference src/blockdeflate.c:42-58.
    """
    sym = np.zeros(512, dtype=np.int32)
    extra = np.zeros(512, dtype=np.int32)
    base = np.zeros(512, dtype=np.int32)
    for code_idx, (ebits, first_off) in enumerate(_OFFSET_CODES):
        span = 1 << ebits
        for off in range(first_off, first_off + span):
            if off <= 256:
                idx = off - 1
            else:
                idx = 256 + ((off - 1 - 256) >> 7)
            sym[idx] = code_idx
            extra[idx] = ebits
            base[idx] = first_off
    # Indices 510/511 correspond to no valid offset; keep them zero like the
    # reference tables' trailing "0, 0" entries.
    sym[510:] = 0
    extra[510:] = 0
    base[510:] = 0
    return sym, extra, base


MATCHLEN_SYMBOL, MATCHLEN_EXTRA_BITS, MATCHLEN_BASE = _build_length_tables()
OFFSET_SYMBOL, OFFSET_EXTRA_BITS, OFFSET_BASE = _build_offset_tables()

# Reverse maps: symbol -> number of extra displacement bits
REV_MATCHLEN_SYMBOL_BITS = np.array(
    [ebits for ebits, _ in _LENGTH_CODES], dtype=np.int32
)
# 32-entry table: 30 valid offset codes + 2 invalid (0 bits)
REV_OFFSET_SYMBOL_BITS = np.array(
    [ebits for ebits, _ in _OFFSET_CODES] + [0, 0], dtype=np.int32
)


def offset_table_index(offset: int) -> int:
    """Index into the two-level offset tables for a match offset 1..32768."""
    idx = offset - 1
    if idx < 256:
        return idx
    return 256 + ((idx - 256) >> 7)


def static_literal_code_lengths() -> np.ndarray:
    """Static Huffman literal/length code lengths (RFC 1951 section 3.2.6)."""
    lengths = np.empty(NLITERALSYMS, dtype=np.int32)
    lengths[0:144] = 8
    lengths[144:256] = 9
    lengths[256:280] = 7
    lengths[280:288] = 8
    return lengths


def static_offset_code_lengths() -> np.ndarray:
    return np.full(NOFFSETSYMS, 5, dtype=np.int32)
