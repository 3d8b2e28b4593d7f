"""Golden byte-for-byte parity against the reference zultra implementation.

The spec of this framework is: identical compressed bitstreams to the
reference binary for every (input, framing, block size, dictionary)
combination, and clean decompression by stock zlib.
"""

import zlib

import pytest

import zultra_tpu as zt

FORMATS = [
    ("gzip", zt.FLAG_GZIP_FRAMING),
    ("zlib", zt.FLAG_ZLIB_FRAMING),
    ("deflate", zt.FLAG_DEFLATE_FRAMING),
]


def _decompress(blob: bytes, flags: int) -> bytes:
    if flags & zt.FLAG_GZIP_FRAMING:
        return zlib.decompress(blob, 15 + 16)
    if flags & zt.FLAG_ZLIB_FRAMING:
        return zlib.decompress(blob, 15)
    return zlib.decompress(blob, -15)


@pytest.mark.parametrize("fmt_name,flags", FORMATS)
def test_parity_corpus(ref_lib, lz_corpus, fmt_name, flags):
    for name, data in lz_corpus.items():
        ref = ref_lib.compress(data, flags)
        mine = zt.compress(data, flags)
        assert mine == ref, f"{name}/{fmt_name}: {len(mine)} vs {len(ref)} bytes"
        assert _decompress(mine, flags) == data


def test_parity_small_inputs(ref_lib):
    for data in [b"a", b"ab", b"abc", b"aaaa", b"\x00", bytes(range(10)),
                 b"x" * 300, b"abcabcabcabc"]:
        for _, flags in FORMATS:
            assert zt.compress(data, flags) == ref_lib.compress(data, flags)


def test_parity_multiwindow_small_blocks(ref_lib, lz_corpus):
    """Exercise the history slide and window chaining with a 32 KB max
    block size (multiple windows without multi-MB spec runtime)."""
    data = lz_corpus["lz_16384_32_0.6"] + lz_corpus["lz_16384_256_0.2"] + lz_corpus["lz_16384_3_0.9"]
    for _, flags in FORMATS:
        ref = ref_lib.compress(data, flags, max_block_size=32768)
        mine = zt.compress(data, flags, max_block_size=32768)
        assert mine == ref


def test_parity_stored_fallback(ref_lib, lz_corpus):
    """Incompressible data triggers the stored-block fallback path."""
    data = lz_corpus["random_32k"]
    for _, flags in FORMATS:
        ref = ref_lib.compress(data, flags, max_block_size=32768)
        mine = zt.compress(data, flags, max_block_size=32768)
        assert mine == ref
        assert _decompress(mine, flags) == data


def test_parity_dictionary(ref_lib, lz_corpus):
    """Preset dictionary path (zlib framing, like the reference CLI)."""
    base = lz_corpus["lz_16384_32_0.6"]
    dictionary = base[:4096]
    data = base[2048:12000]
    ref = ref_lib.compress(data, zt.FLAG_ZLIB_FRAMING, dictionary=dictionary)
    mine = zt.compress(data, zt.FLAG_ZLIB_FRAMING, dictionary=dictionary)
    assert mine == ref
    d = zlib.decompressobj(15, zdict=dictionary)
    assert d.decompress(mine) == data


def test_streaming_chunked_equals_oneshot(lz_corpus):
    """Chunked push-API feeding must produce the identical stream to the
    one-shot path (the window-fill trigger semantics guarantee it for the
    reference as well)."""
    data = lz_corpus["lz_16384_256_0.2"] + lz_corpus["lz_16384_32_0.6"] + lz_corpus["lz_4096_3_0.9"]
    oneshot = zt.compress(data, zt.FLAG_GZIP_FRAMING, max_block_size=32768)
    for chunk in (1024, 16384, 40000):
        stream = zt.Stream(zt.FLAG_GZIP_FRAMING, max_block_size=32768)
        out = bytearray()
        for i in range(0, len(data), chunk):
            out += stream.compress(data[i : i + chunk], zt.CONTINUE)
        out += stream.compress(b"", zt.FINALIZE)
        assert bytes(out) == oneshot


def test_empty_input_errors():
    with pytest.raises(zt.StreamError):
        zt.compress(b"", zt.FLAG_GZIP_FRAMING)


def test_fuzz_parity_short(ref_lib):
    """30-second differential fuzz against the reference library."""
    import fuzz_parity

    count = fuzz_parity.run(30, seed=42, ref=ref_lib)
    assert count > 20


@pytest.mark.slow
def test_fuzz_parity_long(ref_lib):
    """Pinned long-campaign fuzz budget: runs under
    `pytest -m slow`; ZULTRA_FUZZ_SECONDS overrides the 300 s default,
    ZULTRA_FUZZ_SEED the seed (failures dump reproducers to /tmp)."""
    import os

    import fuzz_parity

    seconds = float(os.environ.get("ZULTRA_FUZZ_SECONDS", "300"))
    seed = int(os.environ.get("ZULTRA_FUZZ_SEED", "20260818"))
    count = fuzz_parity.run(seconds, seed=seed, ref=ref_lib)
    assert count > seconds * 2, f"fuzz throughput collapsed: {count} cases"


def test_oversized_dictionary_rejected():
    import zultra_tpu as zt

    stream = zt.Stream(zt.FLAG_ZLIB_FRAMING)
    with pytest.raises(zt.StreamError):
        stream.set_dictionary(b"x" * 40000)


def test_memory_bound_matches_reference(ref_lib):
    import ctypes

    for size in (0, 1, 1000, 65535, 1 << 20, 10 << 20):
        for flags in (0, 1, 2):
            for block in (0, 32768, 2097152):
                ref = ref_lib.lib.zultra_memory_bound(
                    ctypes.c_size_t(size), flags, block
                )
                assert zt.memory_bound(size, flags, block) == ref, (size, flags, block)


def test_parity_jax_engine(ref_lib, lz_corpus, monkeypatch):
    """The jax engine (device staircase matchfinder feeding the native
    planner) emits byte-identical streams. Covers the segmented path
    (>64 KB cores), dictionaries, and the degenerate-input host fallback
    (zeros_16k overflows the membership budget by design)."""
    import zultra_tpu.engine as engine_mod

    eng = engine_mod.JaxEngine()
    monkeypatch.setattr(engine_mod, "_active_engine", eng)
    assert engine_mod.get_engine() is eng

    picks = ["lz_16384_32_0.6", "lz_16384_3_0.9", "zeros_16k", "source_code",
             "random_32k"]
    for name in picks:
        data = lz_corpus[name]
        ref = ref_lib.compress(data, zt.FLAG_GZIP_FRAMING)
        mine = zt.compress(data, zt.FLAG_GZIP_FRAMING)
        assert mine == ref, f"jax engine parity failed on {name}"

    # Dictionary + zlib framing through the jax engine.
    data = lz_corpus["lz_16384_32_0.6"]
    d = data[:2048]
    ref = ref_lib.compress(data, zt.FLAG_ZLIB_FRAMING, dictionary=d)
    mine = zt.compress(data, zt.FLAG_ZLIB_FRAMING, dictionary=d)
    assert mine == ref

    # Multi-window streaming (small blocks force several windows).
    data = lz_corpus["lz_16384_3_0.9"]
    ref = ref_lib.compress(data, zt.FLAG_GZIP_FRAMING, max_block_size=32768)
    mine = zt.compress(data, zt.FLAG_GZIP_FRAMING, max_block_size=32768)
    assert mine == ref
