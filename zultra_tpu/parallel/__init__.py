"""Multi-chip / multi-host scaling via jax.sharding.

The compression problem decomposes data-parallel over windows: after its
32 KB history halo, every window's match finding / parse is independent
(SURVEY.md §2.3, §5). The mesh therefore has two axes:

* ``dp`` — windows sharded across chips (the throughput axis; scales to
  multi-host over DCN because no per-window communication exists at all —
  demonstrated with real 2-process jax.distributed in
  multihost.compress_windows_jax_distributed).
* ``sp`` — bytes *within* a window sharded across chips: the window's
  32 KB-halo segments shard over 'sp' in compression proper
  (ops.matchfinder_jax._sharded_chunk_fn), and the bandwidth-bound
  whole-corpus stages (histograms, checksums) reduce with psum over ICI.

Per-corpus symbol statistics are psum'd; Huffman tables and cost tables
are tiny and replicated. Checksums combine associatively
(ops.checksum), so the gzip/zlib footer of a sharded corpus needs no
sequential pass.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.suffix_jax import _doubling_rounds, _num_levels


def make_mesh(n_dp: int | None = None, n_sp: int = 1, devices=None) -> Mesh:
    """1- or 2-axis device mesh ('dp', 'sp')."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    if n_dp is None:
        n_dp = devices.size // n_sp
    devices = devices[: n_dp * n_sp].reshape(n_dp, n_sp)
    return Mesh(devices, axis_names=("dp", "sp"))


def lanes_mesh(mesh: Mesh) -> Mesh:
    """``mesh`` as an (n, 1) ('dp', 'sp') mesh over the same devices in the
    same order. Stages that split one lane axis over the product of both
    axes and exchange nothing place every lane on the same device either
    way; the (n, 1) form makes every factorisation of n one mesh, so they
    share compiled programs."""
    return Mesh(mesh.devices.reshape(-1, 1), axis_names=("dp", "sp"))


# ---------------------------------------------------------------------------
# Sharded per-window device step
# ---------------------------------------------------------------------------


def _window_device_step(windows: jnp.ndarray, levels: int):
    """Per-device slice of the window batch: build each window's suffix
    array + final ranks, byte histogram over the sp-sharded byte axis,
    Adler partial sums. Collectives: psum over 'sp' for within-window
    reductions, psum over ('dp','sp') for corpus statistics."""
    # windows: (w_local, window_bytes_local) — dp shards axis 0, sp axis 1.
    # The suffix array is a whole-window structure: gather the byte shards
    # over 'sp' (ICI all-gather) before the doubling rounds. The histogram
    # stays on the local shard — genuine sequence-parallel work — and is
    # reduced with a single psum over both axes.
    full = jax.lax.all_gather(windows, "sp", axis=1, tiled=True)

    def one_window(window):
        sa, ranks = _doubling_rounds(window, window.shape[0], levels)
        return sa, ranks[-1]

    sa, rank = jax.vmap(one_window)(full)

    # int32 counts: a float32 sum would be exact only below 2^24 per bin.
    local_hist = jnp.bincount(windows.reshape(-1).astype(jnp.int32), length=256)
    corpus_hist = jax.lax.psum(local_hist, axis_name=("dp", "sp"))

    # Adler-32 partial sums per window (combined on host via
    # ops.checksum.adler32_combine).
    b = full.astype(jnp.int32)
    s1 = jnp.sum(b, axis=1)
    weights = jnp.arange(full.shape[1], 0, -1, dtype=jnp.int32)
    s2 = jnp.sum(b * weights[None, :], axis=1)

    return sa, rank, corpus_hist, s1, s2


def make_sharded_window_step(mesh: Mesh, window_bytes: int):
    """jit a windows-sharded device step over the mesh: windows sharded on
    dp, bytes on sp; corpus histogram replicated out."""
    levels = _num_levels(window_bytes)

    from jax import shard_map

    step = shard_map(
        functools.partial(_window_device_step, levels=levels),
        mesh=mesh,
        in_specs=(P("dp", "sp"),),
        out_specs=(P("dp", None), P("dp", None), P(), P("dp"), P("dp")),
        check_vma=False,
    )
    return jax.jit(step)


def sharded_corpus_stats(data: bytes, mesh: Mesh, window_bytes: int = 1 << 16):
    """Shard a corpus into fixed-size windows across the mesh and compute
    per-window suffix structures + replicated corpus statistics."""
    n_dp = mesh.shape["dp"]
    n_sp = mesh.shape["sp"]
    arr = np.frombuffer(data, dtype=np.uint8)
    n_windows = max(1, -(-len(arr) // window_bytes))
    n_windows = -(-n_windows // n_dp) * n_dp  # round up to dp multiple
    padded = np.zeros(n_windows * window_bytes, dtype=np.uint8)
    padded[: len(arr)] = arr
    windows = padded.reshape(n_windows, window_bytes)
    if window_bytes % n_sp:
        raise ValueError("window_bytes must divide by the sp axis")

    step = make_sharded_window_step(mesh, window_bytes)
    sharding = NamedSharding(mesh, P("dp", "sp"))
    device_windows = jax.device_put(jnp.asarray(windows), sharding)
    sa, rank, hist, s1, s2 = step(device_windows)
    return {
        "suffix_arrays": sa,
        "ranks": rank,
        "corpus_histogram": np.asarray(hist).astype(np.int64),
        "adler_s1": np.asarray(s1),
        "adler_s2": np.asarray(s2),
        "n_windows": n_windows,
    }


# ---------------------------------------------------------------------------
# Mesh-sharded single-stream compression
# ---------------------------------------------------------------------------


def compress_sharded(
    data: bytes,
    mesh: Mesh,
    flags: int = 0,
    max_block_size: int = 0,
    seg_core: int = 65536,
    budget_factor: int = 16,
    dictionary: bytes | None = None,
) -> bytes:
    """Compress one stream with the match stage sharded across the mesh:
    the corpus is cut into the stream's windows, each window into
    32 KB-halo segments, and ALL segments run the device staircase
    matchfinder data-parallel over the 'dp' axis (shard_map). Window
    planning (block split + DP) and ordered bit emission then run on the
    host. Byte-identical to the single-device stream — asserted by
    __graft_entry__.dryrun_multichip and tests/test_parallel.py."""
    import ctypes

    from .. import frame, native
    from ..ops.matchfinder_jax import match_tables_for_spans
    from ..stream import clamp_block_size, memory_bound
    from .multihost import window_spans

    max_block_size = clamp_block_size(max_block_size)
    arr = np.frombuffer(data, dtype=np.uint8)
    # Preset dictionary: the last ≤32 KB preload as fake history before the
    # first window, exactly like the streaming core (stream.py:95-104) —
    # equivalent to prepending the dictionary bytes and shifting spans,
    # with checksum/ISIZE still over the real data only.
    dict_tail = bytes(dictionary or b"")[-32768:]
    d = len(dict_tail)
    full = np.concatenate([np.frombuffer(dict_tail, np.uint8), arr]) if d else arr
    spans = [(lo + d, hi + d) for lo, hi in window_spans(len(data), max_block_size)]

    tables = match_tables_for_spans(
        full, spans, seg_core=seg_core, budget_factor=budget_factor,
        mesh=lanes_mesh(mesh),
    )

    lib = native.get_lib()
    out = bytearray()
    out += frame.encode_header(flags, dict_tail if d else None)
    checksum = frame.update_checksum(frame.init_checksum(flags), arr, flags)

    buf = bytearray(memory_bound(max_block_size, flags, max_block_size))
    bits_data, bits_count = 0, 0
    for w, (w_lo, w_hi) in enumerate(spans):
        prev = min(32768, w_lo)
        window = np.ascontiguousarray(full[w_lo - prev : w_hi])
        handle = lib.zn_window_begin_with_table(
            window, prev, w_hi - w_lo, 0,
            np.ascontiguousarray(tables[w].astype(np.uint16)),
        )
        if not handle:
            raise RuntimeError("native window planning failed")
        n, bits_data, bits_count = native.window_emit(
            handle, w + 1 == len(spans), buf, bits_data, bits_count
        )
        out += buf[:n]
    out += frame.encode_footer(flags, checksum, len(data))
    return bytes(out)


# ---------------------------------------------------------------------------
# Data-parallel corpus compression (host-orchestrated)
# ---------------------------------------------------------------------------


def compress_corpus(blobs, flags=0, max_block_size: int = 0, workers: int | None = None):
    """Compress independent byte streams data-parallel across host worker
    threads (each stream is its own gzip/zlib member; multi-host setups
    shard the blob list by jax.process_index())."""
    from concurrent.futures import ThreadPoolExecutor

    from ..stream import compress

    if workers is None:
        import os

        workers = os.cpu_count() or 2

    with ThreadPoolExecutor(max_workers=workers) as pool:
        return list(pool.map(lambda b: compress(b, flags, max_block_size), blobs))
