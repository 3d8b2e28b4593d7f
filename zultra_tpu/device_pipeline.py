"""Full-device begin-phase: compose the device match finder, device block
splitter, and device block planner into one per-window pipeline, with the
host doing only O(bytes) assembly — table bits (a few hundred per block)
and the ordered bit-phase splice of device-packed token words.

This is the composed form of the per-window hot path the reference runs
on the CPU (reference src/libzultra.c:287-343 match/split trigger +
src/blockdeflate.c:827-997 block driver): match tables, split points,
greedy histograms, the 4-pass DP convergence, Huffman builds, Zopfli A/B,
mask search, and token emission all execute on the device
(ops/matchfinder_jax, ops/split_jax, ops/block_jax); the device→host
download per block is the packed token words (~compressed size) plus a
~400-byte plan, instead of the (n, 8, 2) match table the mixed jax
engine ships.

``DeviceWindowEngine`` (engine name "jaxdev") plugs into the streaming
core's begin/emit pipeline contract, so framing, history slide, stored
fallback, and dictionary handling are identical to every other engine —
the stream bytes are bit-exact with the reference.
"""

from __future__ import annotations

import numpy as np

from .bitwriter import BitWriter, BitWriterError
from .constants import (
    CODELEN_SYM_ORDER,
    NCODELENBITS,
    NCODELENSYMS,
    NLITERALSYMS,
    NOFFSETSYMS,
    NVALIDLITERALSYMS,
    NVALIDOFFSETSYMS,
)
from .huffman import HuffmanEncoder, write_var_lengths


def put_packed_bits(writer: BitWriter, words: np.ndarray, total_bits: int) -> None:
    """Append an LSB-first packed bitstream (uint32 words, bits beyond
    ``total_bits`` zero) at the writer's current bit phase — the
    vectorized equivalent of ``total_bits`` put_bits calls."""
    if total_bits == 0:
        return
    phase = writer.bits_count
    n_in = (total_bits + 7) // 8
    b = np.ascontiguousarray(words).view(np.uint8)[:n_in]
    x = np.zeros(n_in + 1, np.uint16)
    x[:n_in] = b.astype(np.uint16) << phase
    if phase:
        x[1:] |= b.astype(np.uint16) >> (8 - phase)
    x[0] |= writer.bits_data
    out_bytes = (x & 0xFF).astype(np.uint8)

    T = phase + total_bits
    full, left = T // 8, T & 7
    if writer.offset + full > writer.max_offset:
        raise BitWriterError("output buffer overflow")
    writer.out[writer.offset : writer.offset + full] = out_bytes[:full].tobytes()
    writer.offset += full
    writer.bits_data = int(out_bytes[full]) & ((1 << left) - 1) if left else 0
    writer.bits_count = left


def _encoder_from_lengths(n_symbols: int, max_code_length: int, lengths) -> HuffmanEncoder:
    """Rebuild an encoder (canonical codewords) from final code lengths —
    the 19-symbol CL table is the only alphabet the host still issues."""
    enc = HuffmanEncoder(n_symbols, max_code_length, 0)
    enc.code_length[:n_symbols] = [int(x) for x in lengths]
    used = [i for i in range(n_symbols) if enc.code_length[i]]
    enc._issue_canonical(sorted(used, key=lambda i: (enc.code_length[i], i)))
    return enc


def write_block_from_plan(plan: dict, writer: BitWriter) -> None:
    """Emit one planned block's content (tables + tokens) after the
    caller's BFINAL/BTYPE bits — the host half of block_deflate
    (blocks.py:320-368; reference src/blockdeflate.c:958-997)."""
    if plan["is_dynamic"]:
        n_lit, n_off = plan["n_lit"], plan["n_off"]
        te = _encoder_from_lengths(NCODELENSYMS, 7, plan["cl_len"])
        n_cl = te.get_raw_table_size()
        if n_lit > NVALIDLITERALSYMS or n_off > NVALIDOFFSETSYMS or n_cl > NCODELENSYMS:
            raise ValueError("invalid table sizes")
        writer.put_bits(n_lit - 257, 5)
        writer.put_bits(n_off - 1, 5)
        writer.put_bits(n_cl - 4, 4)
        te.write_raw_table(NCODELENBITS, n_cl, writer)
        code_lengths = [int(x) for x in plan["lit_len"][:n_lit]] + [
            int(x) for x in plan["off_len"][:n_off]
        ]
        write_var_lengths(te, n_lit + n_off, code_lengths, plan["best_mask"], writer)
    put_packed_bits(writer, plan["words"], plan["total_bits"])


class _WindowPlan:
    __slots__ = ("plans", "block_spans", "window", "prev", "in_size")

    def __init__(self, plans, block_spans, window, prev, in_size):
        self.plans = plans
        self.block_spans = block_spans
        self.window = window
        self.prev = prev
        self.in_size = in_size


def begin_window_device(window: np.ndarray, prev: int, in_size: int,
                        n_threads: int = 0) -> _WindowPlan:
    """Plan one window entirely on the device: match tables → split →
    batched block plans. The match table stays RESIDENT on the device
    (uint16) — the only downloads are the split points, per-block plans
    (~400 B each), and the packed token words (~compressed size).
    ``n_threads`` is accepted for engine-contract compatibility (the
    device needs no host threads). ZULTRA_JAXDEV_TABLE=host selects the
    round-tripping debug path."""
    import os

    import jax.numpy as jnp

    window = np.asarray(window, dtype=np.uint8)
    n = prev + in_size

    if os.environ.get("ZULTRA_JAXDEV_TABLE") == "host":
        from .ops.block_jax import plan_blocks
        from .ops.matchfinder_jax import match_table_jax
        from .ops.split_jax import block_split_jax

        table = match_table_jax(window, prev, n)
        splits = block_split_jax(window, table, prev, in_size)
        spans = []
        s = prev
        for e in splits:
            spans.append((s, e))
            s = e
        plans = plan_blocks(window, table, spans)
        return _WindowPlan(plans, spans, window, prev, in_size)

    from .ops.block_jax import plan_blocks_device
    from .ops.matchfinder_jax import match_table_device
    from .ops.split_jax import _bucket as _split_bucket
    from .ops.split_jax import _input_cap, _split_kernel, _trig_cap

    lens, offs = match_table_device(window, prev, n)
    win_dev = jnp.asarray(window[:n])

    n_pad_w = _split_bucket(n)
    win_p = jnp.concatenate([win_dev, jnp.zeros(n_pad_w - n, jnp.uint8)])
    tail = jnp.zeros(n_pad_w - n, jnp.int32)
    rl = jnp.concatenate([lens[:, 0].astype(jnp.int32), tail])
    ro = jnp.concatenate([offs[:, 0].astype(jnp.int32), tail])
    in_cap = _input_cap(in_size)
    splits_arr, n_splits, _, ovf = _split_kernel(
        win_p, rl, ro, jnp.int32(prev), jnp.int32(n), n_pad_w,
        in_cap, trig_cap=_trig_cap(in_cap),
    )
    if bool(ovf):
        splits_arr, n_splits, _, _ = _split_kernel(
            win_p, rl, ro, jnp.int32(prev), jnp.int32(n), n_pad_w,
            in_cap, trig_cap=0,
        )
    splits = [int(x) for x in np.asarray(splits_arr[: int(n_splits)])]
    splits.append(n)
    spans = []
    s = prev
    for e in splits:
        spans.append((s, e))
        s = e
    plans = plan_blocks_device(win_dev, lens, offs, spans)
    return _WindowPlan(plans, spans, window, prev, in_size)


def emit_window_from_plan(handle: _WindowPlan, window_is_last: bool,
                          out: bytearray, bits_data: int, bits_count: int):
    """Ordered, bit-phase-dependent emission of a planned window —
    mirrors the stream spec path (stream.py:245-320; reference
    src/libzultra.c:309-402) including the stored-block fallback."""
    writer = BitWriter(out, 0, len(out))
    writer.bits_data = bits_data
    writer.bits_count = bits_count

    n_blocks = len(handle.block_spans)
    for i, ((s, e), plan) in enumerate(zip(handle.block_spans, handle.plans)):
        block_size = e - s
        is_final = 1 if (window_is_last and i == n_blocks - 1) else 0
        saved = writer.state()
        writer.put_bits(is_final, 1)
        writer.put_bits(1 + (1 if plan["is_dynamic"] else 0), 2)
        prev_offset = writer.get_offset()
        try:
            write_block_from_plan(plan, writer)
            expanded = (writer.get_offset() - prev_offset) > block_size
        except BitWriterError:
            expanded = True

        if expanded:
            writer.restore(saved)
            sub_offset = 0
            remaining = block_size
            while remaining:
                sub_size = min(remaining, 65535)
                sub_final = is_final if sub_size == remaining else 0
                writer.put_bits(sub_final, 1)
                writer.put_bits(0, 2)
                writer.flush_bits()
                writer.put_bytes(
                    bytes(
                        [
                            sub_size & 0xFF,
                            (sub_size >> 8) & 0xFF,
                            (sub_size & 0xFF) ^ 0xFF,
                            ((sub_size >> 8) & 0xFF) ^ 0xFF,
                        ]
                    )
                )
                writer.put_bytes(
                    handle.window[s + sub_offset : s + sub_offset + sub_size].tobytes()
                )
                sub_offset += sub_size
                remaining -= sub_size

    if window_is_last:
        writer.flush_bits()
    return writer.get_offset(), writer.bits_data, writer.bits_count


def _begin_windows_batched(corpus: np.ndarray, spans, mbs: int, mesh=None):
    """Plan a BATCH of windows on the device in one composed pass:
    full-occupancy match-table chunks for every window's segments →
    one vmapped split kernel over all lanes → block plans bucketed
    ACROSS windows (the serial DP-scan latency amortizes over the whole
    batch — the begin-phase cost per window drops ~linearly with the
    batch). Returns one _WindowPlan per span, in order.

    Lane layout: every window occupies a (HALO + mbs) device lane with
    its first input byte at offset HALO; its real history bytes (≤32 KB,
    possibly fewer for the first window / a preset dictionary) sit just
    below, zeros elsewhere."""
    import jax.numpy as jnp

    from .constants import HISTORY_SIZE
    from .ops.block_jax import plan_blocks_device_multi
    from .ops.matchfinder_jax import HALO, match_tables_device_stacked
    from .ops.split_jax import (
        _bucket as _split_bucket,
        _input_cap,
        _split_kernel_batch,
        _trig_cap,
    )

    W = len(spans)
    n_lane = HALO + mbs
    lens_st, offs_st = match_tables_device_stacked(corpus, spans, mbs, mesh=mesh)

    win_stack = np.zeros((W, n_lane), np.uint8)
    prevs = []
    for w, (w_lo, w_hi) in enumerate(spans):
        prev = min(HISTORY_SIZE, w_lo)
        prevs.append(prev)
        win_stack[w, HALO - prev : HALO + (w_hi - w_lo)] = corpus[w_lo - prev : w_hi]
    win_dev = jnp.asarray(win_stack)

    n_pad_w = _split_bucket(n_lane)
    win_p = jnp.concatenate(
        [win_dev, jnp.zeros((W, n_pad_w - n_lane), jnp.uint8)], axis=1
    )
    ztail = jnp.zeros((W, n_pad_w - n_lane), jnp.int32)
    rl = jnp.concatenate([lens_st[:, :, 0].astype(jnp.int32), ztail], axis=1)
    ro = jnp.concatenate([offs_st[:, :, 0].astype(jnp.int32), ztail], axis=1)
    n_reals_np = np.array([HALO + (hi - lo) for lo, hi in spans], dtype=np.int32)
    if mesh is None:
        in_cap = _input_cap(mbs)
        splits_arr, n_splits, tok_marks, ovf = _split_kernel_batch(
            win_p, rl, ro, jnp.int32(HALO), jnp.asarray(n_reals_np), n_pad_w,
            in_cap, trig_cap=_trig_cap(in_cap),
        )
        ovf_np = np.asarray(ovf)
        if ovf_np.any():
            # Exact per-lane retry with every candidate slot evaluated.
            full = _split_kernel_batch(
                win_p, rl, ro, jnp.int32(HALO), jnp.asarray(n_reals_np),
                n_pad_w, in_cap, trig_cap=0,
            )
            sel = jnp.asarray(ovf_np)[:, None]
            splits_arr = jnp.where(sel, full[0], splits_arr)
            n_splits = jnp.where(jnp.asarray(ovf_np), full[1], n_splits)
    else:
        from .ops.split_jax import _split_kernel_sharded

        n_dev = mesh.shape["dp"] * mesh.shape["sp"]
        W_pad = -(-W // n_dev) * n_dev
        if W_pad > W:
            zpad = ((0, W_pad - W), (0, 0))
            win_p = jnp.pad(win_p, zpad)
            rl = jnp.pad(rl, zpad)
            ro = jnp.pad(ro, zpad)
            # Padding lanes carry n_real = 0 → no input range, no splits.
            n_reals_np = np.concatenate(
                [n_reals_np, np.zeros(W_pad - W, np.int32)]
            )
        splits_arr, n_splits, tok_marks, _ = _split_kernel_sharded(
            mesh, n_pad_w, _input_cap(mbs)
        )(
            win_p, rl, ro, jnp.full((1,), HALO, jnp.int32),
            jnp.asarray(n_reals_np),
        )
    splits_arr = np.asarray(splits_arr)[:W]
    n_splits = np.asarray(n_splits)[:W]
    tok_stack = tok_marks[:W, :n_lane]  # device-resident greedy marks

    # Flatten every window's blocks into one cross-window lane list.
    lanes = []
    spans_per_window = []
    for w, (w_lo, w_hi) in enumerate(spans):
        ends = [int(x) for x in splits_arr[w, : int(n_splits[w])]]
        ends.append(HALO + (w_hi - w_lo))
        blocks = []
        s = HALO
        for e in ends:
            blocks.append((s, e))
            lanes.append((w, s, e - s))
            s = e
        spans_per_window.append(blocks)

    plans_flat = plan_blocks_device_multi(
        win_dev, lens_st, offs_st, lanes, mesh=mesh, tok_stack=tok_stack
    )

    handles = []
    i = 0
    for w, (w_lo, w_hi) in enumerate(spans):
        prev = prevs[w]
        shift = HALO - prev  # lane coords -> window-buffer coords
        blocks = [(s - shift, e - shift) for (s, e) in spans_per_window[w]]
        n_blocks = len(blocks)
        handles.append(
            _WindowPlan(
                plans_flat[i : i + n_blocks], blocks,
                corpus[w_lo - prev : w_hi], prev, w_hi - w_lo,
            )
        )
        i += n_blocks
    return handles


def compress_device(
    data: bytes,
    flags: int = 0,
    max_block_size: int = 0,
    dictionary: bytes | None = None,
    windows_per_batch: int = 16,
    mesh=None,
) -> bytes:
    """One-shot full-device compression with windows BATCHED through the
    composed begin-phase — the device-scaled form of the reference's
    one-shot API (src/libzultra.c:601-619). Byte-identical to the
    streaming core at the same block size (same window cuts, history
    slides, BFINAL placement, stored fallback, framing).

    With ``mesh`` every device stage distributes over ALL mesh chips:
    match segments, splitter window lanes, and block-plan lanes shard
    over dp×sp (no collectives — the decomposition is communication-free
    past its 32 KB halos). ``windows_per_batch`` then counts PER DEVICE
    (the batch scales with the mesh)."""
    from . import frame
    from .constants import HISTORY_SIZE
    from .device import enable_compile_cache
    from .stream import StreamError, clamp_block_size, memory_bound

    enable_compile_cache()
    mbs = clamp_block_size(max_block_size)
    data_b = bytes(data)
    if not data_b:
        raise StreamError("cannot finalize an empty stream")
    dict_b = bytes(dictionary) if dictionary else b""
    if len(dict_b) > HISTORY_SIZE:
        raise StreamError(
            f"dictionary exceeds the {HISTORY_SIZE}-byte history window"
        )
    corpus = np.frombuffer(dict_b + data_b, dtype=np.uint8)
    base = len(dict_b)
    spans = []
    pos = 0
    while pos < len(data_b):
        hi = min(pos + mbs, len(data_b))
        spans.append((base + pos, base + hi))
        pos = hi

    out = bytearray()
    out += frame.encode_header(flags, dict_b if dict_b else None)
    checksum = frame.init_checksum(flags)
    checksum = frame.update_checksum(checksum, corpus[base:], flags)

    if mesh is not None:
        from .parallel import lanes_mesh

        # Every mesh stage splits lanes over dp x sp with no collectives.
        mesh = lanes_mesh(mesh)
        windows_per_batch *= mesh.shape["dp"]
    buf = bytearray(memory_bound(mbs, flags, mbs))
    bits_data, bits_count = 0, 0
    for g in range(0, len(spans), windows_per_batch):
        group = spans[g : g + windows_per_batch]
        handles = _begin_windows_batched(corpus, group, mbs, mesh=mesh)
        for i, handle in enumerate(handles):
            is_last = g + i + 1 == len(spans)
            n, bits_data, bits_count = emit_window_from_plan(
                handle, is_last, buf, bits_data, bits_count
            )
            out += buf[:n]
    out += frame.encode_footer(flags, checksum, len(data_b))
    return bytes(out)


class _QueuedWindow:
    """Future-like handle for a window awaiting the batched begin-phase.
    ``result()`` forces the engine to plan every queued window in ONE
    composed device batch (the stream's pipeline-depth lookahead becomes
    the device batch)."""

    __slots__ = ("engine", "plan")

    def __init__(self, engine):
        self.engine = engine
        self.plan: _WindowPlan | None = None

    def done(self) -> bool:
        return self.plan is not None

    def result(self) -> _WindowPlan:
        if self.plan is None:
            self.engine._flush_queue()
        assert self.plan is not None
        return self.plan


class DeviceWindowEngine:
    """Engine "jaxdev": the full-device begin-phase. Match finding,
    splitting, block planning, and token emission run on the device; the
    host assembles framing, tables, and the ordered bit splice.

    One-shot compression routes through ``compress_device`` (windows
    batched through the composed device begin-phase). The streaming push
    API queues windows (``queue_window``) and plans the whole lookahead
    in one ``_begin_windows_batched`` call when the stream first needs a
    plan — so ``Stream`` + jaxdev matches the one-shot path's batched
    throughput instead of paying the per-window begin latency (the
    reference's streaming trigger is src/libzultra.c:269-343)."""

    name = "jaxdev"
    pipeline_depth = 16  # windows per device batch through the stream

    def __init__(self):
        import os

        from .device import enable_compile_cache, on_gpu

        enable_compile_cache()
        self._queue: list[tuple[_QueuedWindow, np.ndarray, int, int]] = []
        self._mbs_seen = 0
        # The queued batched begin-phase pays off on the GPU; on the CPU
        # (the test suite) it would only multiply compile shapes, so the
        # stream plans window by window there. ZULTRA_JAXDEV_QUEUE=1/0
        # overrides.
        queued = os.environ.get("ZULTRA_JAXDEV_QUEUE")
        use_queue = on_gpu() if queued is None else queued == "1"
        if use_queue:
            self.queue_window = self._queue_window

    @staticmethod
    def compress_corpus(data, flags=0, max_block_size=0, dictionary=None):
        return compress_device(data, flags, max_block_size, dictionary)

    def find_all_matches(self, window: np.ndarray, start: int, end: int) -> np.ndarray:
        from .ops.matchfinder_jax import match_table_jax

        return match_table_jax(window, start, end)

    # -- streaming batched begin-phase --------------------------------------

    def _queue_window(self, window: np.ndarray, prev: int, in_size: int,
                      n_threads: int = 0) -> _QueuedWindow:
        """Record one stream window for the next batched device begin.
        Called in stream order on the stream's thread; O(window) copy."""
        qw = _QueuedWindow(self)
        self._queue.append((qw, np.asarray(window, np.uint8).copy(), prev, in_size))
        return qw

    def _flush_queue(self) -> None:
        """Plan every queued window in one composed device batch.
        Consecutive stream windows reconstruct a contiguous corpus: the
        first window contributes its full (history + input) bytes, each
        later one only its input — its ≤32 KB history prefix IS the
        previous window's tail (asserted)."""
        entries = self._queue
        self._queue = []
        if not entries:
            return
        _, win0, prev0, in0 = entries[0]
        corpus = bytearray(win0[: prev0 + in0].tobytes())
        spans = [(prev0, prev0 + in0)]
        self._mbs_seen = max(self._mbs_seen, in0)
        from .constants import HISTORY_SIZE

        for _, win, prev, in_size in entries[1:]:
            lo = len(corpus)
            if prev != min(HISTORY_SIZE, lo):
                raise ValueError("queued windows are not consecutive")
            if not np.array_equal(
                win[:prev], np.frombuffer(corpus, np.uint8, prev, lo - prev)
            ):
                raise ValueError("queued window history diverges from stream")
            corpus += win[prev : prev + in_size].tobytes()
            spans.append((lo, lo + in_size))
            self._mbs_seen = max(self._mbs_seen, in_size)

        handles = _begin_windows_batched(
            np.frombuffer(bytes(corpus), np.uint8), spans, self._mbs_seen
        )
        for (qw, _, _, _), handle in zip(entries, handles):
            qw.plan = handle

    # -- per-window contract (direct users / cross-validation) --------------

    def begin_window(self, window: np.ndarray, prev: int, in_size: int,
                     n_threads: int = 0) -> _WindowPlan:
        return begin_window_device(window, prev, in_size, n_threads)

    def emit_window(self, handle: _WindowPlan, window_is_last: bool,
                    out: bytearray, bits_data: int, bits_count: int):
        return emit_window_from_plan(handle, window_is_last, out, bits_data, bits_count)

    def free_window(self, handle: _WindowPlan) -> None:
        pass
