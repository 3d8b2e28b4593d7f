#!/usr/bin/env python3
"""Drive the device engine ("jaxdev") once on an NVIDIA GPU, end to end,
and check every output byte against the host engine ("native").

    python chip_smoke.py                 # one GPU, phases 1-6
    python chip_smoke.py --chips 4       # four GPUs: the mesh paths only
    python chip_smoke.py --rehearse      # the same phases, small, on the CPU
    python chip_smoke.py --rehearse --chips 4   # mesh paths on 4 CPU devices

One GPU, one process, through the public entry points:
  1. bulk      32 MiB text-like corpus, gzip, default 1 MiB blocks,
               zultra_tpu.compress with engine jaxdev
  2. mixed     32 MiB, 15/16 binary-like and 1/16 text-like
  3. stream    Stream fed 16 KiB chunks over 4 MiB (the queued batched
               begin-phase); must equal the one-shot output
  4. dict      zlib with a 32 KiB preset dictionary over 4 MiB
  5. cli       zultra_tpu.cli.main on an 8 MiB file, in this process
  6. dp        the CUDA cost-DP kernel against the XLA scan DP at the
               planner's widths (16 lanes, n_pad buckets up to 2^20)
With --chips 4: compress_device over a 4x1 and a 2x2 mesh, and
compress_sharded over a 4x1 mesh, each on 128 MiB, byte for byte against
the native engine and the one-card compress_device result.

Every phase prints one line: bytes in and out, wall time, the compile
time JAX reported inside it and how many programs it compiled, the
device's peak memory so far, and its parity result (byte equality with
the native engine's output, plus a stock-zlib round trip). Corpora come from
zultra_tpu.corpus and --seed. Without a GPU the script exits non-zero
(--rehearse forces the CPU and never prints the GPU result line). Any
failed phase exits non-zero without the result line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

MiB = 1 << 20

FULL = {
    "bulk": 32 * MiB, "mixed": 32 * MiB, "stream": 4 * MiB, "dict": 4 * MiB,
    "cli": 8 * MiB, "mesh": 128 * MiB, "block": 0,
    "dp_pads": tuple(1 << k for k in range(12, 21)), "dp_lanes": 16,
}
# Rehearsal on the CPU: the same control flow at sizes the CPU compiles
# and runs in minutes (32 KiB blocks, a few windows per phase).
REHEARSE = {
    "bulk": 96 * 1024 + 777, "mixed": 96 * 1024, "stream": 64 * 1024 + 5,
    "dict": 64 * 1024, "cli": 80 * 1024, "mesh": 160 * 1024 + 99,
    "block": 32768, "dp_pads": (4096,), "dp_lanes": 4,
}
DICT_BYTES = 32 * 1024
STREAM_CHUNK = 16 * 1024


class Compiles:
    """Sums what JAX reports about compilation: the number of backend
    compilations and the seconds spent tracing, lowering and compiling."""

    def __init__(self):
        from jax._src import dispatch

        self._backend = dispatch.BACKEND_COMPILE_EVENT
        self._front = (dispatch.JAXPR_TRACE_EVENT, dispatch.JAXPR_TO_MLIR_MODULE_EVENT)
        self.count = 0
        self.seconds = 0.0

    def __call__(self, event, duration, **_):
        if event == self._backend:
            self.count += 1
            self.seconds += duration
        elif event in self._front:
            self.seconds += duration

    def snapshot(self):
        return self.count, self.seconds


def card_line() -> str:
    """nvidia-smi's name and power limit for every card (a child process
    that does not import JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().replace("\n", " | ")


def peak_bytes(device):
    stats = device.memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def gunzip(blob: bytes) -> bytes:
    return zlib.decompress(blob, 15 + 16)


class Runner:
    def __init__(self, devices, compiles):
        self.devices = devices
        self.compiles = compiles
        self.failed = []

    def phase(self, name: str, timed, check, n_in: int, note: str = ""):
        """Time ``timed()``; ``check(result)`` returns (bytes_out, ok,
        details)."""
        import jax

        c0, s0 = self.compiles.snapshot()
        t0 = time.perf_counter()
        result = jax.block_until_ready(timed())
        wall = time.perf_counter() - t0
        c1, s1 = self.compiles.snapshot()
        n_out, ok, details = check(result)
        line = {
            "phase": name, "bytes_in": n_in, "bytes_out": n_out,
            "wall_s": wall, "compile_s": s1 - s0, "compiles": c1 - c0,
            "peak_bytes_in_use": [peak_bytes(d) for d in self.devices],
            "parity": ok, **details,
        }
        if note:
            line["note"] = note
        print("phase " + json.dumps(line), flush=True)
        if not ok:
            self.failed.append(name)


def one_card(cfg, seed: int, runner: Runner, rehearse: bool) -> None:
    import zultra_tpu as zt
    from zultra_tpu import cli, corpus, engine
    from zultra_tpu.stream import CONTINUE, FINALIZE, Stream

    mbs = cfg["block"]
    gz, zl = zt.FLAG_GZIP_FRAMING, zt.FLAG_ZLIB_FRAMING

    def native(data, flags, dictionary=None):
        engine.set_engine("native")
        return zt.compress(data, flags, mbs, dictionary=dictionary)

    def jaxdev(data, flags, dictionary=None):
        engine.set_engine("jaxdev")
        return zt.compress(data, flags, mbs, dictionary=dictionary)

    def archive(names, data):
        ref = native(data, gz)
        for name in names:
            runner.phase(
                name, lambda: jaxdev(data, gz),
                lambda out: (len(out), out == ref and gunzip(out) == data,
                             {"ratio_pct": 100.0 * len(out) / len(data)}),
                len(data),
            )

    # 1-2. bulk text archive (run twice: the second run shows that the
    # warmed shapes compile nothing more) and the binary-heavy mix.
    archive(("bulk", "bulk_again"), corpus.text_like(cfg["bulk"], seed))
    archive(("mixed",), corpus.mixed(cfg["mixed"], seed))

    # 3. streaming: 16 KiB pushes through Stream vs the one-shot output.
    data = corpus.text_like(cfg["stream"], seed + 3)
    ref = native(data, gz)
    one_shot = jaxdev(data, gz)

    def stream():
        engine.set_engine("jaxdev")
        st = Stream(gz, mbs)
        parts = []
        for off in range(0, len(data), STREAM_CHUNK):
            last = off + STREAM_CHUNK >= len(data)
            parts.append(st.compress(data[off : off + STREAM_CHUNK],
                                     FINALIZE if last else CONTINUE))
        return b"".join(parts)

    runner.phase(
        "stream", stream,
        lambda out: (len(out), out == one_shot == ref and gunzip(out) == data, {}),
        len(data),
    )

    # 4. zlib with a 32 KiB preset dictionary.
    data = corpus.text_like(cfg["dict"], seed + 4)
    dictionary = corpus.text_like(DICT_BYTES, seed + 40)
    ref = native(data, zl, dictionary)

    def inflate(blob):
        d = zlib.decompressobj(15, zdict=dictionary)
        return d.decompress(blob) + d.flush()

    runner.phase(
        "dict", lambda: jaxdev(data, zl, dictionary),
        lambda out: (len(out), out == ref and inflate(out) == data, {}),
        len(data),
    )

    # 5. the CLI, called in this process (a child would open the GPU again).
    data = corpus.text_like(cfg["cli"], seed + 5)
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = Path(tmp) / "in.bin", Path(tmp) / "out.gz"
        src.write_bytes(data)
        engine.set_engine("native")
        ref = zt.compress(data, gz)  # the CLI uses the default block size

        def run_cli():
            engine.set_engine("jaxdev")
            rc = cli.main(["-gzip", str(src), str(dst)])
            return rc, dst.read_bytes()

        runner.phase(
            "cli", run_cli,
            lambda r: (len(r[1]), r[0] == 0 and r[1] == ref and gunzip(r[1]) == data,
                       {"rc": r[0]}),
            len(data),
            note="default block size" if mbs == 0 else "rehearsal: the CLI's default block",
        )

    # 6. the cost-DP kernel against the scan at the planner's widths.
    dp_check(cfg, seed, runner, rehearse)


def dp_check(cfg, seed: int, runner: Runner, rehearse: bool) -> None:
    import jax
    import numpy as np

    from zultra_tpu import corpus
    from zultra_tpu.ops.block_jax import run_dp_scan

    scan = jax.jit(run_dp_scan, static_argnames=("n_pad",))
    if rehearse:
        kernel = None  # CUDA has no CPU form; the rehearsal checks the scan runs
    else:
        from zultra_tpu.ops.dp_cuda import run_dp_cuda

        kernel = jax.jit(run_dp_cuda, static_argnames=("n_pad",))

    lanes = cfg["dp_lanes"]
    fn = kernel if kernel is not None else scan
    for n_pad in cfg["dp_pads"]:
        args = [jax.numpy.asarray(a) for a in corpus.dp_lanes(seed + n_pad, lanes, n_pad)]
        t0 = time.perf_counter()
        ref = jax.block_until_ready(scan(*args, n_pad=n_pad))
        scan_s = time.perf_counter() - t0
        jax.block_until_ready(fn(*args, n_pad=n_pad))  # compile outside the timing

        def check(got, ref=ref, scan_s=scan_s, n_pad=n_pad):
            ok = all(np.array_equal(np.asarray(a), np.asarray(b))
                     for a, b in zip(got, ref))
            return 0, ok, {"lanes": lanes, "n_pad": n_pad,
                           "scan_s_compile_included": scan_s,
                           "kernel": "cuda" if kernel is not None else "none (CPU)"}

        runner.phase(f"dp[{n_pad}]", lambda: fn(*args, n_pad=n_pad), check,
                     lanes * n_pad)


def mesh(cfg, seed: int, runner: Runner) -> None:
    import zultra_tpu as zt
    from zultra_tpu import corpus, engine
    from zultra_tpu.device_pipeline import compress_device
    from zultra_tpu.parallel import compress_sharded, make_mesh

    devices = runner.devices
    if len(devices) < 4:
        raise SystemExit(f"--chips 4 needs 4 devices, JAX found {len(devices)}")
    t0 = time.perf_counter()
    data = corpus.text_like(cfg["mesh"], seed)
    t1 = time.perf_counter()
    mbs = cfg["block"]
    gz = zt.FLAG_GZIP_FRAMING
    engine.set_engine("native")
    ref = zt.compress(data, gz, mbs)
    print("setup " + json.dumps({"corpus_s": t1 - t0,
                                 "native_s": time.perf_counter() - t1}), flush=True)
    results = {}

    def keep(name):
        def check(out):
            results[name] = out
            return len(out), out == ref and gunzip(out) == data, {}
        return check

    for name, (n_dp, n_sp) in (("mesh_4x1", (4, 1)), ("mesh_2x2", (2, 2))):
        m = make_mesh(n_dp=n_dp, n_sp=n_sp, devices=devices[:4])
        runner.phase(name, lambda m=m: compress_device(data, gz, mbs, mesh=m),
                     keep(name), len(data))
    # Every card must have carried a share of the mesh work (the CPU
    # keeps no memory statistics, so a rehearsal cannot tell).
    peaks = [peak_bytes(d) for d in devices[:4]]
    if None not in peaks:
        spread = min(peaks) / max(max(peaks), 1)
        print("phase " + json.dumps({"phase": "mesh_spread", "peak_bytes_in_use": peaks,
                                     "min_over_max": spread, "parity": spread >= 0.25}),
              flush=True)
        if spread < 0.25:
            runner.failed.append("mesh_spread")
    m = make_mesh(n_dp=4, n_sp=1, devices=devices[:4])
    runner.phase("sharded_4x1", lambda: compress_sharded(data, m, gz, mbs),
                 keep("sharded_4x1"), len(data))
    runner.phase(
        "one_card", lambda: compress_device(data, gz, mbs),
        lambda out: (len(out),
                     out == ref and gunzip(out) == data
                     and all(r == out for r in results.values()),
                     {"compared": sorted(results)}),
        len(data),
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1)
    ap.add_argument("--rehearse", action="store_true",
                    help="run small phases on the CPU; prints no device result")
    args = ap.parse_args(argv)

    import jax

    if args.rehearse:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", args.chips)
    devices = jax.devices()
    platform = devices[0].platform
    if not args.rehearse and platform != "gpu":
        print(f"chip_smoke: no GPU; JAX found platform {platform!r}", file=sys.stderr)
        return 2

    from zultra_tpu.device import enable_compile_cache

    cfg = REHEARSE if args.rehearse else FULL
    print(f"card: {'none (rehearsal on the CPU)' if args.rehearse else card_line()}",
          flush=True)
    print(f"jax {jax.__version__}, {len(devices)} x {devices[0].device_kind}, "
          f"compile cache {enable_compile_cache()}", flush=True)

    compiles = Compiles()
    jax.monitoring.register_event_duration_secs_listener(compiles)
    runner = Runner(devices[: args.chips], compiles)
    t0 = time.perf_counter()
    if args.chips == 4:
        mesh(cfg, args.seed, runner)
    else:
        one_card(cfg, args.seed, runner, args.rehearse)
    print(f"total_s {time.perf_counter() - t0:.3f}", flush=True)

    if runner.failed:
        print(f"chip_smoke: FAILED phases: {', '.join(runner.failed)}", file=sys.stderr)
        return 1
    if args.rehearse:
        print("rehearsal passed (CPU): no device result", flush=True)
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
