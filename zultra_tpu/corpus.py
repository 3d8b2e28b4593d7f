"""Seeded synthetic corpora for the chip smoke run, the benchmark and the
tests: the same seed gives the same bytes, and nothing is read from
outside the package.

* ``text_like`` — words drawn from a Zipf-weighted vocabulary of
  letter strings, with separators and recurring multi-word phrases: the
  enwik8/text class of the reference's published table, though not its
  ratio (the result is labelled synthetic wherever it is reported).
* ``binary_like`` — executable-like tokens: a Zipf-weighted opcode
  vocabulary, little-endian addresses near a few bases, small
  immediates, zero padding runs, and incompressible resource stretches.
* ``mixed`` — 15 × 256 KiB of binary-like bytes interleaved with
  1 × 256 KiB of text-like bytes, the binary-heavy archive class
  (Silesia's mozilla: a tarball of executables).

Bytes are generated 1 MiB at a time, each piece from its own child seed,
so a corpus of any size is built in bulk with bounded memory.
"""

from __future__ import annotations

import numpy as np

PIECE = 1 << 20
MIX_STEP = 256 << 10

# Letter weights of English text (a..z), rounded per mille.
_LETTER_WEIGHTS = np.array(
    [82, 15, 28, 43, 127, 22, 20, 61, 70, 2, 8, 40, 24,
     67, 75, 19, 1, 60, 63, 91, 28, 10, 24, 2, 20, 1], np.float64
)


def _zipf_weights(n: int, s: float) -> np.ndarray:
    w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** s
    return w / w.sum()


def _join(tokens: list[bytes]) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Flat byte table + (offset, length) per token."""
    lens = np.array([len(t) for t in tokens], np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    flat = np.frombuffer(b"".join(tokens), np.uint8)
    return flat, offs, lens


def _emit(rng, flat, offs, lens, probs, size: int) -> np.ndarray:
    """Sample tokens by ``probs`` until ``size`` bytes, concatenated."""
    out = []
    total = 0
    mean = float(np.dot(probs, lens))
    while total < size:
        n = int((size - total) / mean) + 64
        ids = rng.choice(len(lens), size=n, p=probs)
        ln = lens[ids]
        starts = np.cumsum(ln) - ln
        pos = np.arange(int(ln.sum()), dtype=np.int64)
        src = np.repeat(offs[ids] - starts, ln) + pos
        piece = flat[src]
        out.append(piece)
        total += piece.size
    return np.concatenate(out)[:size]


def _text_tables(rng):
    n_words = 20000
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)
    p_letter = _LETTER_WEIGHTS / _LETTER_WEIGHTS.sum()
    wl = np.clip(rng.geometric(0.22, n_words), 1, 14)
    words = [
        letters[rng.choice(26, size=int(k), p=p_letter)].tobytes() for k in wl
    ]
    p_word = _zipf_weights(n_words, 1.1)
    seps = [b" ", b", ", b". ", b".\n", b"\n\n", b"; "]
    p_sep = np.array([0.80, 0.08, 0.06, 0.04, 0.01, 0.01])
    n_phrases = 3000
    phrases = []
    for _ in range(n_phrases):
        k = int(rng.integers(3, 9))
        ids = rng.choice(n_words, size=k, p=p_word)
        phrases.append(b" ".join(words[i] for i in ids) + b" ")
    tokens = [w + s for w in words for s in seps] + phrases
    p_tok = np.concatenate([
        (p_word[:, None] * p_sep[None, :]).reshape(-1) * 0.9,
        _zipf_weights(n_phrases, 1.0) * 0.1,
    ])
    return _join(tokens), p_tok / p_tok.sum()


def _binary_tables(rng):
    n_ops = 400
    ops = [rng.integers(0, 256, int(rng.integers(1, 8)), dtype=np.uint8).tobytes()
           for _ in range(n_ops)]
    bases = rng.integers(0x400000, 0x7FFFFFFF, 6, dtype=np.int64)
    addrs = [
        int((bases[i % 6] + 16 * int(rng.integers(0, 1 << 14))) & 0xFFFFFFFF)
        .to_bytes(4, "little")
        for i in range(2000)
    ]
    imms = [int(v).to_bytes(int(rng.integers(1, 3)), "little")
            for v in rng.integers(0, 256, 400)]
    zeros = [bytes(int(k)) for k in (4, 8, 12, 16, 24, 32, 48, 64)]
    tokens = ops + addrs + imms + zeros
    p_tok = np.concatenate([
        _zipf_weights(n_ops, 1.2) * 0.55,
        _zipf_weights(len(addrs), 1.1) * 0.25,
        np.full(len(imms), 0.17 / len(imms)),
        np.full(len(zeros), 0.03 / len(zeros)),
    ])
    return _join(tokens), p_tok / p_tok.sum()


def _pieces(size: int, seed: int, salt: int, make_piece) -> bytes:
    seq = np.random.SeedSequence([seed, salt])
    children = seq.spawn(-(-size // PIECE))
    out = bytearray()
    for child in children:
        rng = np.random.default_rng(child)
        out += make_piece(rng, min(PIECE, size - len(out))).tobytes()
    return bytes(out)


def text_like(size: int, seed: int) -> bytes:
    """``size`` bytes of synthetic text from ``seed``."""
    tables = _text_tables(np.random.default_rng([seed, 1]))

    def piece(rng, n):
        (flat, offs, lens), probs = tables
        return _emit(rng, flat, offs, lens, probs, n)

    return _pieces(size, seed, 1, piece)


def binary_like(size: int, seed: int) -> bytes:
    """``size`` bytes of synthetic executable-like data from ``seed``.
    One thirty-second of every piece is random bytes (embedded resources
    that do not compress)."""
    tables = _binary_tables(np.random.default_rng([seed, 2]))

    def piece(rng, n):
        (flat, offs, lens), probs = tables
        body = _emit(rng, flat, offs, lens, probs, n)
        k = n // 32
        if k:
            at = int(rng.integers(0, n - k + 1))
            body[at : at + k] = rng.integers(0, 256, k, dtype=np.uint8)
        return body

    return _pieces(size, seed, 2, piece)


def mixed(size: int, seed: int) -> bytes:
    """``size`` bytes: 15 × 256 KiB binary-like, then 256 KiB text-like,
    repeated."""
    n_groups = -(-size // (16 * MIX_STEP))
    binary = binary_like(n_groups * 15 * MIX_STEP, seed)
    text = text_like(n_groups * MIX_STEP, seed)
    parts = []
    for g in range(n_groups):
        parts.append(binary[g * 15 * MIX_STEP : (g + 1) * 15 * MIX_STEP])
        parts.append(text[g * MIX_STEP : (g + 1) * MIX_STEP])
    return b"".join(parts)[:size]


def dp_lanes(seed: int, lanes: int, n_pad: int, density: float = 0.5):
    """Random cost-DP operands in the planner's layout, as numpy arrays:
    (lit_lens (B, 288), off_lens (B, 32), window (B, n_pad) uint8,
    mlens/moffs (B, n_pad, 8) int32 with each row's lengths descending,
    lengths (B,)). A slot holds a match with probability ``density``;
    lane 0 is cut to a third of n_pad so a block end falls inside it."""
    from .constants import NLITERALSYMS, NMATCHES_PER_OFFSET, NOFFSETSYMS

    rng = np.random.default_rng(seed)
    shape = (lanes, n_pad, NMATCHES_PER_OFFSET)
    window = rng.integers(0, 256, (lanes, n_pad), dtype=np.uint8)
    has = rng.random(shape) < density
    mlens = np.where(has, rng.integers(3, 259, shape), 0).astype(np.int32)
    moffs = np.where(has, rng.integers(1, 32769, shape), 1).astype(np.int32)
    order = np.argsort(-mlens, axis=2, kind="stable")
    mlens = np.take_along_axis(mlens, order, axis=2)
    moffs = np.take_along_axis(moffs, order, axis=2)
    lit_lens = rng.integers(1, 16, (lanes, NLITERALSYMS)).astype(np.int32)
    off_lens = rng.integers(1, 16, (lanes, NOFFSETSYMS)).astype(np.int32)
    lengths = np.full(lanes, n_pad, np.int32)
    lengths[0] = max(1, n_pad // 3)
    return lit_lens, off_lens, window, mlens, moffs, lengths
