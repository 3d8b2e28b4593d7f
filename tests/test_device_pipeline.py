"""The composed full-device begin-phase (ops/block_jax + device_pipeline):
block-level bit-identity against the host block driver, stream-level
byte-identity of the "jaxdev" engine, and the packed-bit splice."""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _set_engine(name):
    from zultra_tpu import engine

    engine.set_engine(name)


@pytest.fixture(autouse=True)
def _restore_engine():
    yield
    from zultra_tpu import engine

    engine._active_engine = None


def test_put_packed_bits_all_phases():
    """The vectorized packed-bit splice equals bit-by-bit put_bits at
    every starting phase."""
    from zultra_tpu.bitwriter import BitWriter
    from zultra_tpu.device_pipeline import put_packed_bits

    rng = np.random.RandomState(5)
    for phase in range(8):
        for total_bits in (1, 7, 8, 9, 31, 32, 33, 200, 1017):
            bits = rng.randint(0, 2, total_bits)
            words = np.zeros((total_bits + 31) // 32, np.uint32)
            for i, b in enumerate(bits):
                words[i // 32] |= np.uint32(int(b) << (i % 32))

            buf1 = bytearray(1024)
            w1 = BitWriter(buf1, 0, 1024)
            if phase:
                w1.put_bits(0x5A & ((1 << phase) - 1), phase)
            for b in bits:
                w1.put_bits(int(b), 1)

            buf2 = bytearray(1024)
            w2 = BitWriter(buf2, 0, 1024)
            if phase:
                w2.put_bits(0x5A & ((1 << phase) - 1), phase)
            put_packed_bits(w2, words, total_bits)

            assert (w1.offset, w1.bits_data, w1.bits_count) == (
                w2.offset, w2.bits_data, w2.bits_count
            ), (phase, total_bits)
            assert buf1[: w1.offset] == buf2[: w2.offset], (phase, total_bits)


def test_plan_block_kernel_equals_host_block_deflate(lz_corpus):
    """Device block plans reproduce the host block driver bit for bit:
    same static/dynamic choice and identical emitted block content
    (tables + tokens) at phase 0, across dynamic, static-prone, and
    RLE-adoption data shapes."""
    from zultra_tpu.bitwriter import BitWriter
    from zultra_tpu.blocks import (
        block_deflate,
        evaluate_dynamic_cost,
        evaluate_static_cost,
        prepare_cost_evaluation,
    )
    from zultra_tpu.device_pipeline import write_block_from_plan
    from zultra_tpu.native import build_match_table
    from zultra_tpu.ops.block_jax import plan_blocks

    cases = [
        lz_corpus["lz_4096_3_0.9"],
        lz_corpus["lz_4096_256_0.2"],
        lz_corpus["lz_16384_32_0.6"],
        lz_corpus["source_code"][:10000],
        bytes(range(256)) * 4,  # static-prone: flat histogram
    ]
    for data in cases:
        arr = np.frombuffer(data, np.uint8).copy()
        n = len(arr)
        table = build_match_table(arr.copy(), 0).astype(np.int32)

        lit_e, off_e = prepare_cost_evaluation(arr, table, 0, n)
        st = evaluate_static_cost(lit_e, off_e)
        lit_e.estimate_dynamic_codelens()
        off_e.estimate_dynamic_codelens()
        dy = evaluate_dynamic_cost(lit_e, off_e)
        is_dynamic = not (st <= dy)

        buf = bytearray(4 * n + 1024)
        w = BitWriter(buf, 0, len(buf))
        best = np.zeros((n, 2), np.int32)
        block_deflate(arr, table, best, 0, n, is_dynamic, w)
        w.flush_bits()
        expect = bytes(buf[: w.offset])

        [plan] = plan_blocks(arr, table, [(0, n)])
        assert plan["is_dynamic"] == is_dynamic, len(data)
        buf2 = bytearray(4 * n + 1024)
        w2 = BitWriter(buf2, 0, len(buf2))
        write_block_from_plan(plan, w2)
        w2.flush_bits()
        got = bytes(buf2[: w2.offset])
        assert got == expect, (len(data), plan["is_dynamic"])


def test_jaxdev_engine_stream_parity(lz_corpus):
    """The jaxdev engine (device match -> split -> plan -> emit) produces
    byte-identical streams to the native engine, multi-window with
    history slide."""
    import zultra_tpu as zt

    data = (lz_corpus["lz_16384_32_0.6"] * 6)[: 2 * 32768 + 1234]
    _set_engine("native")
    expect = zt.compress(data, zt.FLAG_GZIP_FRAMING, 32768)
    _set_engine("jaxdev")
    got = zt.compress(data, zt.FLAG_GZIP_FRAMING, 32768)
    assert got == expect

    import zlib

    assert zlib.decompress(got, 15 + 16) == data


def test_jaxdev_engine_dictionary_and_zlib(lz_corpus):
    """jaxdev with a preset dictionary under zlib framing."""
    import zlib

    import zultra_tpu as zt

    data = lz_corpus["lz_16384_3_0.9"]
    dictionary = lz_corpus["source_code"][:3000]
    _set_engine("native")
    expect = zt.compress(data, zt.FLAG_ZLIB_FRAMING, 32768, dictionary=dictionary)
    _set_engine("jaxdev")
    got = zt.compress(data, zt.FLAG_ZLIB_FRAMING, 32768, dictionary=dictionary)
    assert got == expect
    d = zlib.decompressobj(zdict=dictionary)
    assert d.decompress(got) + d.flush() == data


def test_jaxdev_engine_stored_fallback():
    """Incompressible input drives jaxdev through the stored-block
    rewind path, byte-identical to the host."""
    import zultra_tpu as zt

    data = np.random.RandomState(11).bytes(40000)
    _set_engine("native")
    expect = zt.compress(data, zt.FLAG_GZIP_FRAMING, 32768)
    _set_engine("jaxdev")
    got = zt.compress(data, zt.FLAG_GZIP_FRAMING, 32768)
    assert got == expect


def test_jaxdev_fallback_accounting_degenerate():
    """Long single-byte runs overflow the staircase membership budget;
    the accounting records the host-walked segments and the stream stays
    byte-identical (the documented degradation mode)."""
    import zultra_tpu as zt
    from zultra_tpu.ops.matchfinder_jax import FALLBACK_STATS

    data = b"a" * 80000 + b"the quick brown fox " * 200 + b"b" * 40000
    _set_engine("native")
    expect = zt.compress(data, zt.FLAG_GZIP_FRAMING, 32768)
    _set_engine("jaxdev")
    FALLBACK_STATS["segments"] = FALLBACK_STATS["overflowed"] = 0
    got = zt.compress(data, zt.FLAG_GZIP_FRAMING, 32768)
    assert got == expect
    assert FALLBACK_STATS["segments"] > 0
    assert 0 <= FALLBACK_STATS["overflowed"] <= FALLBACK_STATS["segments"]


def test_jaxdev_fallback_near_zero_on_text(lz_corpus):
    """Normal text data must NOT fall back to the host walk."""
    import zultra_tpu as zt
    from zultra_tpu.ops.matchfinder_jax import FALLBACK_STATS

    data = lz_corpus["source_code"][:65536]
    _set_engine("jaxdev")
    FALLBACK_STATS["segments"] = FALLBACK_STATS["overflowed"] = 0
    zt.compress(data, zt.FLAG_GZIP_FRAMING, 32768)
    assert FALLBACK_STATS["segments"] > 0
    assert FALLBACK_STATS["overflowed"] == 0


def test_compress_device_batch_grouping(lz_corpus):
    """compress_device with several window groups (windows_per_batch
    smaller than the window count) and a partial last window is
    byte-identical to the native stream."""
    import zultra_tpu as zt
    from zultra_tpu.device_pipeline import compress_device

    data = (lz_corpus["source_code"] * 40)[: 5 * 32768 + 4321]
    _set_engine("native")
    expect = zt.compress(data, zt.FLAG_GZIP_FRAMING, 32768)
    got = compress_device(data, zt.FLAG_GZIP_FRAMING, 32768, windows_per_batch=2)
    assert got == expect


def test_compress_device_mesh_sharded(lz_corpus):
    """The COMPOSED device begin-phase sharded over the full 8-device
    mesh (match segments, splitter lanes, and block-plan lanes all
    distribute over dp×sp) is byte-identical to the host stream."""
    import zultra_tpu as zt
    from zultra_tpu.device_pipeline import compress_device
    from zultra_tpu.parallel import make_mesh

    data = (lz_corpus["source_code"] * 40)[: 5 * 32768 + 987]
    _set_engine("native")
    expect = zt.compress(data, zt.FLAG_GZIP_FRAMING, 32768)
    mesh = make_mesh(n_dp=4, n_sp=2)
    got = compress_device(data, zt.FLAG_GZIP_FRAMING, 32768, mesh=mesh)
    assert got == expect


def test_jaxdev_queued_stream_batch_parity(lz_corpus, monkeypatch):
    """The streaming queued begin-phase (windows batched through ONE
    composed device begin per pipeline-depth lookahead) emits the same
    bytes as the one-shot path and the native engine — including a
    chunked feed that splits windows across compress() calls."""
    import numpy as np

    import zultra_tpu as zt
    from zultra_tpu import engine as engine_mod
    from zultra_tpu.stream import Stream

    monkeypatch.setenv("ZULTRA_JAXDEV_QUEUE", "1")
    data = (lz_corpus["source_code"] * 30)[: 3 * 32768 + 1531]
    expect = zt.compress(data, zt.FLAG_GZIP_FRAMING, 32768)

    prev_engine = zt.get_engine()
    engine_mod.set_engine("jaxdev")
    try:
        assert hasattr(zt.get_engine(), "queue_window")
        s = Stream(zt.FLAG_GZIP_FRAMING, 32768)
        out = bytearray()
        for off in range(0, len(data), 50_000):  # chunks straddle windows
            out += s.compress(data[off : off + 50_000])
        out += s.compress(b"", 1)
        assert bytes(out) == expect
    finally:
        engine_mod._active_engine = prev_engine
