"""Mesh sharding: the dp×sp window step, psum'd corpus statistics, and the
driver entry points, on an 8-virtual-device CPU mesh."""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def test_sharded_corpus_stats_8dev():
    import jax

    from zultra_tpu.parallel import make_mesh, sharded_corpus_stats

    assert len(jax.devices()) == 8, jax.devices()
    mesh = make_mesh(n_dp=4, n_sp=2)
    rng = np.random.RandomState(0)
    data = rng.bytes(3 * 4096 + 123)
    stats = sharded_corpus_stats(data, mesh, window_bytes=4096)
    arr = np.frombuffer(data, np.uint8)
    expect = np.bincount(arr, minlength=256)
    got = stats["corpus_histogram"].copy()
    # Padding bytes are zeros; subtract them from bucket 0.
    got[0] -= stats["n_windows"] * 4096 - len(arr)
    assert np.array_equal(got, expect)

    # Per-window suffix arrays match the host construction.
    from zultra_tpu.suffix import suffix_array_numpy

    windows = np.zeros(stats["n_windows"] * 4096, dtype=np.uint8)
    windows[: len(arr)] = arr
    windows = windows.reshape(stats["n_windows"], 4096)
    for w in range(stats["n_windows"]):
        assert np.array_equal(
            np.asarray(stats["suffix_arrays"][w]), suffix_array_numpy(windows[w])
        ), f"window {w}"


def test_sharded_adler_combine_matches_zlib():
    import zlib

    from zultra_tpu.ops.checksum import adler32_combine
    from zultra_tpu.parallel import make_mesh, sharded_corpus_stats

    mesh = make_mesh(n_dp=8, n_sp=1)
    rng = np.random.RandomState(1)
    data = rng.bytes(8 * 2048)
    stats = sharded_corpus_stats(data, mesh, window_bytes=2048)
    # Fold the per-window partial sums into the stream checksum.
    adler = 1
    base = 65521
    for w in range(stats["n_windows"]):
        s1 = int(stats["adler_s1"][w]) % base
        s2 = int(stats["adler_s2"][w]) % base
        shard = (((s2 + 2048) % base) << 16) | ((s1 + 1) % base)
        adler = adler32_combine(adler, shard, 2048)
    assert adler == zlib.adler32(data)


def test_graft_entry_single_chip():
    import jax

    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)


def test_graft_dryrun_multichip():
    import __graft_entry__ as g

    g.dryrun_multichip(8)


def test_compress_corpus_threads(lz_corpus):
    import zlib

    import zultra_tpu as zt
    from zultra_tpu.parallel import compress_corpus

    blobs = [lz_corpus["lz_4096_3_0.9"], lz_corpus["lz_4096_256_0.2"]] * 3
    outs = compress_corpus(blobs, zt.FLAG_ZLIB_FRAMING)
    for blob, out in zip(blobs, outs):
        assert zlib.decompress(out) == blob


def test_profiling_stage_timers():
    from zultra_tpu.profiling import stage_report, stage_timer

    with stage_timer("unit"):
        pass
    report = stage_report(reset=True)
    assert report["unit"]["calls"] == 1


def test_stream_stats(lz_corpus):
    import zultra_tpu as zt
    from zultra_tpu.profiling import stream_stats

    s = zt.Stream(zt.FLAG_GZIP_FRAMING)
    s.compress(lz_corpus["lz_4096_3_0.9"], zt.FINALIZE)
    stats = stream_stats(s)
    assert stats["total_in"] == 4096
    assert 0 < stats["ratio_pct"] < 100


def test_engine_env_selection(monkeypatch):
    import zultra_tpu.engine as eng

    monkeypatch.setattr(eng, "_active_engine", None)
    monkeypatch.setenv("ZULTRA_ENGINE", "spec")
    assert eng.get_engine().name == "spec"
    monkeypatch.setattr(eng, "_active_engine", None)
    monkeypatch.delenv("ZULTRA_ENGINE", raising=False)
    assert eng.get_engine().name in ("native", "spec")


def test_multihost_shard_and_members(lz_corpus):
    import zlib

    import zultra_tpu as zt
    from zultra_tpu.parallel.multihost import (
        compress_shard_members,
        process_info,
        shard_blobs,
    )

    idx, count = process_info()
    assert idx == 0 and count >= 1
    blobs = [lz_corpus["lz_4096_3_0.9"], lz_corpus["lz_4096_256_0.2"],
             lz_corpus["lz_16384_32_0.6"]]
    mine = shard_blobs(blobs, 0, 2)
    assert mine == [blobs[0], blobs[2]]
    members = compress_shard_members(mine, zt.FLAG_GZIP_FRAMING)
    # Concatenated gzip members form a valid multi-member gzip stream.
    import gzip

    assert gzip.decompress(b"".join(members)) == b"".join(mine)
    for blob, member in zip(mine, members):
        assert zlib.decompress(member, 31) == blob


def test_multihost_bench_scaling_smoke(lz_corpus):
    from zultra_tpu.parallel.multihost import bench_scaling

    data = lz_corpus["lz_16384_256_0.2"] * 4
    res = bench_scaling(data, worker_counts=(1,))
    assert res[1]["MBps"] > 0
    assert res[1]["efficiency"] == 1.0


def test_allreduce_sum_over_devices():
    """Named-axis psum over the full (virtual 8-CPU) device set: the
    collective core of the multi-host histogram reduction."""
    import jax

    from zultra_tpu.parallel.multihost import allreduce_sum_over_devices

    devices = jax.devices()
    rng = np.random.RandomState(7)
    per_dev = rng.randint(0, 1000, (len(devices), 288)).astype(np.int64)
    total = allreduce_sum_over_devices(per_dev, devices)
    assert np.array_equal(total, per_dev.sum(axis=0))


def test_windows_mode_multihost_byte_identical(lz_corpus):
    """The multi-host 'windows' single-stream mode (per-worker window
    planning + host-0 ordered emission at the true bit phase) produces a
    byte-identical stream at every worker count."""
    import zlib

    import zultra_tpu as zt
    from zultra_tpu.parallel.multihost import compress_windows_multihost

    data = (lz_corpus["lz_16384_32_0.6"] * 10)[: 3 * 32768 + 555]
    expect = zt.compress(data, zt.FLAG_GZIP_FRAMING, 32768)
    for workers in (1, 2, 3):
        got = compress_windows_multihost(data, zt.FLAG_GZIP_FRAMING, 32768, workers)
        assert got == expect, workers
    assert zlib.decompress(expect, 15 + 16) == data


def test_compress_sharded_mesh_byte_identical(lz_corpus):
    """Full compression with the match stage sharded over the 8-device
    mesh equals the single-device stream byte for byte."""
    import zultra_tpu as zt
    from zultra_tpu.parallel import compress_sharded, make_mesh

    data = (lz_corpus["source_code"] * 4)[: 2 * 32768 + 100]
    mesh = make_mesh(n_dp=8, n_sp=1)
    got = compress_sharded(data, mesh, zt.FLAG_GZIP_FRAMING,
                           max_block_size=32768, seg_core=32768)
    expect = zt.compress(data, zt.FLAG_GZIP_FRAMING, 32768)
    assert got == expect


def test_compress_sharded_chunked_dispatch(lz_corpus, monkeypatch):
    """Match segments beyond MESH_CHUNK per device go out in several
    dispatches of one shape; the stream is unchanged."""
    import zultra_tpu as zt
    from zultra_tpu.ops import matchfinder_jax
    from zultra_tpu.parallel import compress_sharded, make_mesh

    monkeypatch.setattr(matchfinder_jax, "MESH_CHUNK", 1)
    data = (lz_corpus["source_code"] * 4)[: 2 * 32768 + 100]
    got = compress_sharded(data, make_mesh(n_dp=4, n_sp=2),
                           zt.FLAG_GZIP_FRAMING, max_block_size=32768,
                           seg_core=8192)
    assert got == zt.compress(data, zt.FLAG_GZIP_FRAMING, 32768)


def test_lanes_mesh_one_mesh_per_device_count():
    """Every factorisation of the same devices becomes one (n, 1) mesh, in
    the same device order, so the lane-split stages share programs."""
    import jax

    from zultra_tpu.parallel import lanes_mesh, make_mesh

    flat = lanes_mesh(make_mesh(n_dp=8, n_sp=1))
    assert lanes_mesh(make_mesh(n_dp=4, n_sp=2)) == flat
    assert lanes_mesh(make_mesh(n_dp=2, n_sp=4)) == flat
    assert dict(flat.shape) == {"dp": 8, "sp": 1}
    assert list(flat.devices.reshape(-1)) == jax.devices()[:8]


def test_compress_sharded_dictionary_byte_identical(lz_corpus):
    """Sharded compression with a preset dictionary equals the streaming
    core's dictionary path byte for byte (zlib framing carries DICTID)."""
    import zlib

    import zultra_tpu as zt
    from zultra_tpu.parallel import compress_sharded, make_mesh

    data = (lz_corpus["source_code"] * 3)[: 32768 + 777]
    dictionary = lz_corpus["source_code"][:4096]
    mesh = make_mesh(n_dp=8, n_sp=1)
    got = compress_sharded(data, mesh, zt.FLAG_ZLIB_FRAMING,
                           max_block_size=32768, seg_core=32768,
                           dictionary=dictionary)
    expect = zt.compress(data, zt.FLAG_ZLIB_FRAMING, 32768,
                         dictionary=dictionary)
    assert got == expect
    d = zlib.decompressobj(zdict=dictionary)
    assert d.decompress(got) + d.flush() == data


def test_window_plan_serialization_roundtrip(lz_corpus):
    """A serialized window plan emits the same bytes as the original job."""
    import numpy as np

    from zultra_tpu import native
    from zultra_tpu.stream import memory_bound

    data = np.frombuffer(lz_corpus["lz_16384_3_0.9"], dtype=np.uint8)
    lib = native.get_lib()
    h1 = lib.zn_window_begin(np.ascontiguousarray(data), 0, len(data), 1)
    blob = native.serialize_window(h1)
    h2 = native.deserialize_window(blob)
    buf1 = bytearray(memory_bound(len(data)))
    buf2 = bytearray(memory_bound(len(data)))
    n1, bd1, bc1 = native.window_emit(h1, True, buf1, 0, 0)
    n2, bd2, bc2 = native.window_emit(h2, True, buf2, 0, 0)
    assert (n1, bd1, bc1) == (n2, bd2, bc2)
    assert buf1[:n1] == buf2[:n2]


import pytest


@pytest.mark.parametrize("n_procs", [2, 4])
def test_windows_mode_jax_distributed(lz_corpus, tmp_path, n_procs):
    """Windows mode through REAL jax.distributed: coordinated processes
    (gloo CPU collectives), each planning its window span, plans AND
    checksum partials exchanged via process_allgather, process 0
    stitching with associative checksum combines — the output is
    byte-identical to the single-process stream."""
    import socket
    import subprocess
    import sys

    import zultra_tpu as zt

    data = (lz_corpus["source_code"] * 80)[: (2 * n_procs + 1) * 32768 + 321]
    corpus = tmp_path / "corpus.bin"
    corpus.write_bytes(data)
    out_path = tmp_path / "dist_out.gz"

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    script = (
        "import os, sys\n"
        "os.environ['JAX_PLATFORMS'] = 'cpu'\n"
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "jax.config.update('jax_cpu_collectives_implementation', 'gloo')\n"
        "pid = int(sys.argv[1])\n"
        "jax.distributed.initialize(coordinator_address='localhost:%d',\n"
        "                           num_processes=%d, process_id=pid)\n"
        "sys.path.insert(0, %r)\n"
        "import zultra_tpu as zt\n"
        "from zultra_tpu.parallel.multihost import compress_windows_jax_distributed\n"
        "data = open(%r, 'rb').read()\n"
        "blob = compress_windows_jax_distributed(data, zt.FLAG_GZIP_FRAMING, 32768)\n"
        "assert (blob is None) == (pid != 0)\n"
        "if pid == 0:\n"
        "    open(%r, 'wb').write(blob)\n"
    ) % (port, n_procs, str(Path(__file__).resolve().parent.parent), str(corpus), str(out_path))

    procs = [
        subprocess.Popen(
            [sys.executable, "-c", script, str(i)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for i in range(n_procs)
    ]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), outs

    expect = zt.compress(data, zt.FLAG_GZIP_FRAMING, 32768)
    assert out_path.read_bytes() == expect


def test_windows_mode_dictionary_byte_identical(lz_corpus):
    """Windows mode with a preset dictionary (config-4 shape: block/window
    data parallelism with shared history) equals the streaming core's
    dictionary path byte for byte, with worker-side checksum partials."""
    import zlib

    import zultra_tpu as zt
    from zultra_tpu.parallel.multihost import compress_windows_multihost

    data = (lz_corpus["source_code"] * 40)[: 4 * 32768 + 913]
    dictionary = lz_corpus["source_code"][:8192]
    got = compress_windows_multihost(
        data, zt.FLAG_ZLIB_FRAMING, 32768, workers=2, dictionary=dictionary
    )
    expect = zt.compress(data, zt.FLAG_ZLIB_FRAMING, 32768, dictionary=dictionary)
    assert got == expect
    d = zlib.decompressobj(zdict=dictionary)
    assert d.decompress(got) + d.flush() == data
