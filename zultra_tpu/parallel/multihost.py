"""Multi-host corpus compression and scaling measurement.

The decomposition is embarrassingly parallel across hosts: the corpus
(file list or one large file cut at window boundaries) shards by
process index over DCN; each host compresses its shard-stream
independently; the only cross-host traffic is the psum of corpus
statistics and the associative checksum combine — both O(KB).

Two output modes:
* ``members``  — each shard becomes its own gzip/zlib member
  (concatenated gzip members are themselves a valid gzip stream).
* ``windows``  — shards cut at max-block-size boundaries with 32 KB
  halos produce one *single* deflate stream: every shard's windows are
  planned independently; the final bit-phase stitching runs on host 0
  (cheap, ordered — the same begin/emit split the thread pipeline uses).

``compress_windows_jax_distributed`` is the real multi-process form:
every jax.distributed process plans its contiguous span of windows, the
serialized plans (explicit fixed-layout blobs, zn_window_serialize) are
gathered with a jax collective (process_allgather over the gloo CPU /
ICI backend), and process 0 stitches the single bit-exact stream.
``compress_windows_multihost`` is the same decomposition driven by
forked OS workers on one machine — used by the scaling bench
(bench_scaling), which measures real scaling efficiency of the
shard-parallel path.
"""

from __future__ import annotations

import os
import time

import numpy as np


def process_info():
    """(process_index, process_count) — jax.distributed if initialized,
    else single process."""
    try:
        import jax

        return jax.process_index(), jax.process_count()
    except Exception:
        return 0, 1


def shard_blobs(blobs, process_index: int, process_count: int):
    """Round-robin shard a corpus file list across hosts."""
    return [b for i, b in enumerate(blobs) if i % process_count == process_index]


def compress_shard_members(blobs, flags=0, max_block_size: int = 0):
    """Compress this host's shard of a corpus; returns the list of
    compressed members (order preserved within the shard)."""
    from ..stream import compress

    return [compress(b, flags, max_block_size) for b in blobs]


def allreduce_sum_over_devices(per_device_values, devices=None):
    """Sum one vector per device across a 1-axis mesh with a named-axis
    psum (shard_map). ``per_device_values``: array (n_devices, k); returns
    the (k,) total. This is the collective core of corpus_histogram_psum,
    unit-testable on the virtual CPU mesh."""
    import functools

    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    devices = list(devices if devices is not None else jax.devices())
    vals = np.asarray(per_device_values)
    assert vals.shape[0] == len(devices), (vals.shape, len(devices))
    mesh = Mesh(np.asarray(devices), ("hosts",))

    @functools.partial(
        shard_map, mesh=mesh, in_specs=P("hosts"), out_specs=P(), check_vma=False
    )
    def reduce_step(x):  # x: (1, k) local shard
        return jax.lax.psum(x, "hosts")[0]

    arr = jax.device_put(jnp.asarray(vals), NamedSharding(mesh, P("hosts")))
    return np.asarray(jax.jit(reduce_step)(arr))


def corpus_histogram_psum(local_hist: np.ndarray):
    """psum a per-host histogram across hosts (replicated result):
    each process contributes its histogram on its first local device and
    zeros on the rest, then one named-axis psum over a global 1-axis mesh
    sums them. Passthrough for one host."""
    _, count = process_info()
    if count == 1:
        return local_hist
    import jax

    local = jax.local_devices()
    per_device = np.zeros((len(local), np.shape(local_hist)[0]), dtype=np.asarray(local_hist).dtype)
    per_device[0] = local_hist
    # Global mesh over every device of every process; each process supplies
    # only its local shards (jax.make_array_from_process_local_data).
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    devices = np.asarray(jax.devices())
    mesh = Mesh(devices, ("hosts",))
    sharding = NamedSharding(mesh, P("hosts"))
    global_vals = jax.make_array_from_process_local_data(sharding, per_device)

    import functools

    from jax import shard_map

    @functools.partial(
        shard_map, mesh=mesh, in_specs=P("hosts"), out_specs=P(), check_vma=False
    )
    def reduce_step(x):
        return jax.lax.psum(x, "hosts")[0]

    return np.asarray(jax.jit(reduce_step)(global_vals))


# ---------------------------------------------------------------------------
# "windows" mode: ONE deflate stream planned across hosts
# ---------------------------------------------------------------------------
#
# Window planning (suffix array, match finding, block split, DP — ~98% of
# the work) is bit-phase independent, so each worker plans a contiguous
# span of max-block-size windows using only its span plus the previous
# 32 KB (available by construction from the input cut). Plans serialize
# to flat blobs (native zn_window_serialize); host 0 deserializes them IN
# STREAM ORDER and emits at the true running bit phase — the same
# begin/emit split the in-process thread pipeline uses, stretched over a
# process/DCN boundary. Output is byte-identical to the single-process
# stream. Stored-block fallbacks stay correct because emission (where
# byte alignment happens) is centralized.


def window_spans(total: int, max_block_size: int):
    """The stream's window boundaries: [lo, hi) byte ranges, one per
    window, exactly as the streaming core cuts them."""
    spans = []
    pos = 0
    while pos < total:
        in_size = min(max_block_size, total - pos)
        spans.append((pos, pos + in_size))
        pos += in_size
    return spans


def span_checksum_partial(data, lo: int, hi: int, flags: int):
    """Worker-side checksum partial over the contiguous byte span
    [lo, hi): (value, length). Combined on host 0 with the associative
    ops.checksum combines — the pod-scale replacement for re-hashing the
    whole corpus on one host (reference src/frame.c:454-480 runs the
    running checksum inline; windows mode distributes it)."""
    import zlib

    from ..constants import FLAG_GZIP_FRAMING, FLAG_ZLIB_FRAMING

    chunk = bytes(data[lo:hi])
    if flags & FLAG_GZIP_FRAMING:
        return zlib.crc32(chunk) & 0xFFFFFFFF, hi - lo
    if flags & FLAG_ZLIB_FRAMING:
        return zlib.adler32(chunk) & 0xFFFFFFFF, hi - lo
    return 0, hi - lo


def combine_checksum_partials(parts, flags: int) -> int:
    """Tree-combinable reduction of ordered (value, length) partials into
    the stream checksum (ops.checksum.crc32_combine/adler32_combine)."""
    from ..constants import FLAG_GZIP_FRAMING, FLAG_ZLIB_FRAMING
    from ..ops.checksum import adler32_combine, crc32_combine

    if flags & FLAG_GZIP_FRAMING:
        acc = 0
        for value, length in parts:
            acc = crc32_combine(acc, value, length)
        return acc
    if flags & FLAG_ZLIB_FRAMING:
        acc = 1
        for value, length in parts:
            acc = adler32_combine(acc, value, length)
        return acc
    return 0


def plan_window_span(data, window_spans_slice, n_threads: int = 1):
    """Plan the given windows of ``data`` (full corpus bytes or a
    memoryview); returns serialized plan blobs, one per window. Runs on
    any worker — only data[lo-32768 : hi] is touched per window."""
    import ctypes

    import numpy as np

    from .. import native
    from ..constants import HISTORY_SIZE

    lib = native.get_lib()
    blobs = []
    for lo, hi in window_spans_slice:
        prev = min(HISTORY_SIZE, lo)
        window = np.frombuffer(data[lo - prev : hi], dtype=np.uint8)
        handle = lib.zn_window_begin(
            np.ascontiguousarray(window), prev, hi - lo, n_threads
        )
        if not handle:
            raise RuntimeError("native window planning failed")
        try:
            blobs.append(native.serialize_window_compact(handle))
        finally:
            lib.zn_window_free(ctypes.c_void_p(handle))
    return blobs


def stitch_window_plans(blobs, flags, data, max_block_size: int,
                        checksum_parts=None, data_len: int | None = None,
                        dictionary: bytes | None = None) -> bytes:
    """Host-0 step: emit planned windows in stream order at the true bit
    phase, wrap in container framing. With ``checksum_parts`` (ordered
    worker (value, length) partials) the stream checksum is an O(workers)
    associative combine — host 0 never re-reads the corpus bytes; without
    them (single-process path) it hashes ``data`` directly."""
    from .. import frame, native
    from ..stream import memory_bound

    if data_len is None:
        data_len = len(data)
    out = bytearray()
    out += frame.encode_header(flags, dictionary)
    if checksum_parts is not None:
        total = sum(length for _, length in checksum_parts)
        if total != data_len:
            raise ValueError("checksum partials do not cover the stream")
        checksum = combine_checksum_partials(checksum_parts, flags)
    else:
        checksum = frame.init_checksum(flags)
        checksum = frame.update_checksum(
            checksum, np.frombuffer(data, dtype=np.uint8), flags
        )

    # Window byte spans (compact blobs carry no window bytes): the same
    # decomposition every planner used, over dict + data corpus coords.
    from ..constants import HISTORY_SIZE

    dict_b = dictionary if dictionary else b""
    base = len(dict_b)
    spans = [(base + lo, base + hi)
             for lo, hi in window_spans(data_len, max_block_size)]
    corpus = None  # assembled lazily; fork/dist paths pass full data

    buf = bytearray(memory_bound(max_block_size, flags, max_block_size))
    bits_data, bits_count = 0, 0
    for i, blob in enumerate(blobs):
        if len(blob) >= 4 and blob[:4] == (0x5A504C33).to_bytes(4, "little"):
            if corpus is None:
                corpus = dict_b + (data.tobytes() if hasattr(data, "tobytes")
                                   else bytes(data))
            lo, hi = spans[i]
            prev = min(HISTORY_SIZE, lo)
            window = np.frombuffer(corpus, np.uint8, hi - (lo - prev), lo - prev)
            handle = native.deserialize_window_compact(blob, window)
        else:
            handle = native.deserialize_window(blob)
        n, bits_data, bits_count = native.window_emit(
            handle, i + 1 == len(blobs), buf, bits_data, bits_count
        )
        out += buf[:n]
    out += frame.encode_footer(flags, checksum, data_len)
    return bytes(out)


# Corpus handoff to forked planner workers: fork children inherit the
# parent's memory, so the data needs no file/pipe round trip at all —
# a 16 MiB shard would otherwise pay a write+read per measurement.
_FORK_DATA = None


def _plan_span_worker(args):
    spans, n_threads, flags = args
    blobs = plan_window_span(_FORK_DATA, spans, n_threads)
    part = span_checksum_partial(_FORK_DATA, spans[0][0], spans[-1][1], flags)
    return blobs, part


def compress_windows_multihost(
    data: bytes, flags: int = 0, max_block_size: int = 0, workers: int = 2,
    dictionary: bytes | None = None,
) -> bytes:
    """Single-stream compression with window planning fanned out across
    worker processes (the pod equivalent: one span per host over DCN,
    blobs gathered to host 0). Byte-identical to the one-process stream.
    A preset ``dictionary`` (≤32 KB) prefixes the first window's history
    exactly like the streaming core's set_dictionary (config-4 shape:
    data-parallel over blocks WITH a shared dictionary).

    The workers are forked: call this only from a process that has not
    opened a GPU, since CUDA state does not survive a fork."""
    import multiprocessing as mp

    from ..constants import HISTORY_SIZE
    from ..stream import StreamError, clamp_block_size

    global _FORK_DATA
    max_block_size = clamp_block_size(max_block_size)
    dict_b = bytes(dictionary) if dictionary else b""
    if len(dict_b) > HISTORY_SIZE:
        raise StreamError(
            f"dictionary exceeds the {HISTORY_SIZE}-byte history window"
        )
    base = len(dict_b)
    corpus = dict_b + bytes(data) if dict_b else data
    spans = [(base + lo, base + hi)
             for lo, hi in window_spans(len(data), max_block_size)]
    if workers <= 1 or len(spans) == 1:
        blobs = plan_window_span(corpus, spans)
        return stitch_window_plans(
            blobs, flags, data, max_block_size, data_len=len(data),
            dictionary=dict_b if dict_b else None,
        )

    # Contiguous, balanced window ranges per worker. Each worker also
    # hashes its own byte span; host 0 only combines the ordered
    # partials.
    per = -(-len(spans) // workers)
    chunks = [spans[i : i + per] for i in range(0, len(spans), per)]

    _FORK_DATA = corpus
    try:
        ctx = mp.get_context("fork")
        with ctx.Pool(len(chunks)) as pool:
            results = pool.map(_plan_span_worker, [(c, 1, flags) for c in chunks])
    finally:
        _FORK_DATA = None
    blobs = [b for blobs_c, _ in results for b in blobs_c]
    parts = [part for _, part in results]
    return stitch_window_plans(blobs, flags, data, max_block_size,
                               checksum_parts=parts, data_len=len(data),
                               dictionary=dict_b if dict_b else None)


def compress_windows_jax_distributed(
    data: bytes, flags: int = 0, max_block_size: int = 0,
    dictionary: bytes | None = None,
) -> bytes | None:
    """Windows mode over an initialized ``jax.distributed`` job: this
    process plans its contiguous span of the stream's windows, all
    processes exchange serialized plans through one allgather collective
    (gloo over TCP on CPU backends, NCCL between GPUs), and process 0
    stitches the single deflate stream at the true running bit phase.

    Returns the compressed bytes on process 0, ``None`` elsewhere. The
    output is byte-identical to the single-process stream (the reference
    semantics of src/libzultra.c:200-514, decomposed by window).

    ``data`` must be the full corpus on every process (the usual corpus-
    on-shared-storage pod setup); each process only *plans* its own span.
    """
    import jax
    from jax.experimental import multihost_utils

    from ..stream import clamp_block_size

    import os
    import time

    prof = os.environ.get("ZULTRA_DIST_PROFILE") == "1"
    marks = [("start", time.perf_counter())]

    idx, count = jax.process_index(), jax.process_count()
    max_block_size = clamp_block_size(max_block_size)
    dict_b = bytes(dictionary) if dictionary else b""
    base = len(dict_b)
    corpus = dict_b + bytes(data) if dict_b else data
    spans = [(base + lo, base + hi)
             for lo, hi in window_spans(len(data), max_block_size)]
    per = -(-len(spans) // count)
    mine = spans[idx * per : (idx + 1) * per]
    blobs = plan_window_span(corpus, mine)
    marks.append(("plan", time.perf_counter()))
    part = (
        span_checksum_partial(corpus, mine[0][0], mine[-1][1], flags)
        if mine else (0, 0)
    )
    marks.append(("checksum", time.perf_counter()))

    # Frame this process's blobs with u32 length prefixes — headed by the
    # 12-byte checksum partial (value u32, length u64) — pad to the
    # global max, and exchange with ONE allgather (two collectives total:
    # the scalar size gather sizes the padded buffer).
    local = bytearray()
    local += int(part[0]).to_bytes(4, "little")
    local += int(part[1]).to_bytes(8, "little")
    for b in blobs:
        local += len(b).to_bytes(4, "little") + b
    sizes = multihost_utils.process_allgather(np.int64(len(local)))
    padded = np.zeros(int(sizes.max()), np.uint8)
    padded[: len(local)] = np.frombuffer(bytes(local), np.uint8)
    marks.append(("serialize", time.perf_counter()))
    gathered = np.asarray(multihost_utils.process_allgather(padded))
    marks.append(("allgather", time.perf_counter()))

    if prof:
        import sys as _sys

        stages = {
            marks[i][0]: marks[i][1] - marks[i - 1][1]
            for i in range(1, len(marks))
        }
        print(f"[dist p{idx}] " + " ".join(
            f"{k}={v:.2f}s" for k, v in stages.items()
        ), file=_sys.stderr, flush=True)

    if idx != 0:
        return None
    all_blobs = []
    parts = []
    for pi in range(count):
        row = gathered[pi].tobytes()[: int(sizes[pi])]
        parts.append((int.from_bytes(row[0:4], "little"),
                      int.from_bytes(row[4:12], "little")))
        o = 12
        while o < len(row):
            ln = int.from_bytes(row[o : o + 4], "little")
            all_blobs.append(row[o + 4 : o + 4 + ln])
            o += 4 + ln
    assert len(all_blobs) == len(spans)
    t_dec = time.perf_counter()
    out = stitch_window_plans(all_blobs, flags, data, max_block_size,
                              checksum_parts=parts, data_len=len(data),
                              dictionary=dict_b if dict_b else None)
    if prof:
        import sys as _sys

        print(f"[dist p0] stitch={time.perf_counter() - t_dec:.2f}s "
              f"blob_bytes={sum(len(b) for b in all_blobs)}",
              file=_sys.stderr, flush=True)
    return out


# ---------------------------------------------------------------------------
# Scaling-efficiency measurement (process-parallel shards on one machine;
# on a pod this is one process per host instead)
# ---------------------------------------------------------------------------


def bench_scaling(data: bytes, worker_counts=(1, 2), flags=0, max_block_size: int = 0):
    """Measure shard-parallel throughput at several worker counts and the
    resulting scaling efficiency. Returns a dict keyed by worker count."""
    import subprocess
    import sys
    import tempfile

    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        blob_path = os.path.join(tmp, "corpus.bin")
        with open(blob_path, "wb") as f:
            f.write(data)

        for workers in worker_counts:
            # Cut into per-worker shards of whole 1 MiB-ish pieces.
            shard_size = -(-len(data) // workers)
            spans = [
                (w * shard_size, min((w + 1) * shard_size, len(data)))
                for w in range(workers)
            ]
            script = (
                "import sys, time, pickle\n"
                "sys.path.insert(0, %r)\n"
                "import zultra_tpu as zt\n"
                "lo, hi = int(sys.argv[1]), int(sys.argv[2])\n"
                "data = open(%r, 'rb').read()[lo:hi]\n"
                "t0 = time.perf_counter()\n"
                "out = zt.compress(data, %d, %d)\n"
                "elapsed = time.perf_counter() - t0\n"
                "print(len(out), elapsed)\n"
            ) % (os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                 blob_path, flags, max_block_size)

            procs = [
                subprocess.Popen(
                    [sys.executable, "-c", script, str(lo), str(hi)],
                    stdout=subprocess.PIPE, text=True,
                    # JAX_PLATFORMS=cpu: the workers never open the GPU,
                    # which admits one process per card.
                    env={**os.environ, "ZN_THREADS": "1",
                         "ZULTRA_PIPELINE_WORKERS": "1",
                         "JAX_PLATFORMS": "cpu"},
                )
                for lo, hi in spans
            ]
            # Parallel time = the slowest worker's *compute* time, so
            # interpreter startup does not pollute the measurement (on a
            # pod each host's process is long-lived).
            worker_times = []
            for p in procs:
                out, _ = p.communicate()
                assert p.returncode == 0, out
                _, elapsed = out.split()
                worker_times.append(float(elapsed))
            wall = max(worker_times)
            results[workers] = {
                "wall_s": wall,
                "MBps": len(data) / 1e6 / wall,
            }

    base = results[min(worker_counts)]["MBps"] * min(worker_counts)
    for workers, r in results.items():
        r["efficiency"] = r["MBps"] / (base / min(worker_counts) * workers)
    return results
