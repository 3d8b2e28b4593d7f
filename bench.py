"""Benchmark driver: end-to-end compression throughput with bit-exact
parity checking against the reference zultra binary.

Prints ONE JSON line:
  {"metric": ..., "value": ..., "unit": "MB/s", "vs_baseline": ...}

vs_baseline is the ratio against the reference's published enwik8
compression speed (3.38 MB/s, README.md:16 / BASELINE.md). enwik8 itself
is not available offline, so the corpus is a seeded synthetic text
stand-in (zultra_tpu.corpus); the same bytes are fed to the reference
binary for the parity check when its source tree is present.

Env knobs:
  BENCH_BYTES   corpus size (default 100 MB — the enwik8 regime of
                BASELINE.md, default 1 MB blocks)
  BENCH_PARITY  "0" to skip the reference parity run (default on)
  BENCH_JAX     "0" to skip the device-engine slice (default on)
  BENCH_SCALING "0" to skip the windows-mode scaling probe (default on)
  BENCH_SA      "0" to skip the batched device-SA vs host SA-IS probe
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

BASELINE_MBPS = 3.38  # reference zultra on enwik8 (README.md:16)
REF_BUILD = Path("/tmp/zultra_ref_build")


def build_corpus(target_bytes: int) -> bytes:
    """Synthetic text corpus (zultra_tpu.corpus.text_like, seed 1)."""
    from zultra_tpu import corpus

    return corpus.text_like(target_bytes, 1)


def build_mixed_corpus(target_bytes: int) -> bytes:
    """Binary-heavy corpus (zultra_tpu.corpus.mixed, seed 1): 15/16
    executable-like bytes and 1/16 text, the class of the reference's
    mozilla row (35.69%; README.md:10-46 of the reference)."""
    from zultra_tpu import corpus

    return corpus.mixed(target_bytes, 1)


def ensure_reference() -> Path | None:
    binary = REF_BUILD / "zultra"
    if binary.exists():
        return binary
    src = Path("/root/reference")
    if not src.exists():
        return None
    import shutil

    shutil.copytree(src, REF_BUILD, dirs_exist_ok=True)
    try:
        subprocess.run(["make", "-j4"], cwd=REF_BUILD, check=True, capture_output=True)
    except Exception:
        return None
    return binary if binary.exists() else None


def main() -> int:
    target = int(os.environ.get("BENCH_BYTES", 100_000_000))
    corpus = build_corpus(target)

    import zultra_tpu as zt

    # Warm up (build/load native lib, spin threads).
    zt.compress(corpus[: 1 << 20], zt.FLAG_GZIP_FRAMING)

    # Best of 2: two samples bound the host's run-to-run noise at modest
    # cost.
    elapsed = None
    for _ in range(2):
        t0 = time.perf_counter()
        blob = zt.compress(corpus, zt.FLAG_GZIP_FRAMING)
        run = time.perf_counter() - t0
        elapsed = run if elapsed is None else min(elapsed, run)
    mbps = len(corpus) / 1e6 / elapsed

    # Validate with stock zlib.
    import zlib

    assert zlib.decompress(blob, 15 + 16) == corpus, "stock zlib roundtrip failed"

    parity_delta = None
    ref_mbps = None
    if os.environ.get("BENCH_PARITY", "1") != "0":
        ref_bin = ensure_reference()
        if ref_bin is not None:
            inp = Path("/tmp/zultra_bench_in.bin")
            outp = Path("/tmp/zultra_bench_ref.gz")
            inp.write_bytes(corpus)
            t0 = time.perf_counter()
            subprocess.run(
                [str(ref_bin), "-gzip", str(inp), str(outp)],
                check=True, capture_output=True,
            )
            ref_elapsed = time.perf_counter() - t0
            ref_mbps = len(corpus) / 1e6 / ref_elapsed
            ref_blob = outp.read_bytes()
            parity_delta = 0 if ref_blob == blob else abs(len(ref_blob) - len(blob)) or 1

    # Mixed text+binary corpus variant: binary-heavy, with its own
    # reference-binary parity check.
    mixed_metrics = {}
    if os.environ.get("BENCH_MIXED", "1") != "0":
        try:
            msize = min(len(corpus), 32 << 20)
            mixed = build_mixed_corpus(msize)
            t0 = time.perf_counter()
            mblob = zt.compress(mixed, zt.FLAG_GZIP_FRAMING)
            m_elapsed = time.perf_counter() - t0
            mixed_metrics = {
                "mixed_corpus_MBps": round(len(mixed) / 1e6 / m_elapsed, 3),
                "mixed_corpus_ratio_pct": round(100.0 * len(mblob) / len(mixed), 2),
            }
            ref_bin = ensure_reference()
            if ref_bin is not None and os.environ.get("BENCH_PARITY", "1") != "0":
                inp = Path("/tmp/zultra_bench_mixed_in.bin")
                outp = Path("/tmp/zultra_bench_mixed_ref.gz")
                inp.write_bytes(mixed)
                subprocess.run(
                    [str(ref_bin), "-gzip", str(inp), str(outp)],
                    check=True, capture_output=True,
                )
                mixed_metrics["mixed_corpus_parity_delta_bytes"] = (
                    0 if outp.read_bytes() == mblob else 1
                )
        except Exception as exc:  # pragma: no cover
            mixed_metrics = {"mixed_corpus_error": str(exc)[:120]}

    # Windows-mode scaling first: it forks worker processes, which must
    # happen before this process opens a GPU (the jax slice below does).
    scaling = {}
    if os.environ.get("BENCH_SCALING", "1") != "0":
        try:
            from zultra_tpu.parallel import multihost

            # 32 MiB: ≥16 windows per worker at 2 workers — big enough to
            # amortize the fork/IPC fixed costs that capped the 16 MiB
            # probe at ~0.78 (the loss is overhead, not contention:
            # planning the same half concurrently in two processes costs
            # +3%, and the halves are balanced to 1%).
            sl = corpus[: 32 << 20]
            single = None
            # Pinned methodology: 5 repeats per
            # width, single-threaded planners (ZN_THREADS pinned by
            # plan_window_span's n_threads=1), best-of as the headline
            # and the full spread recorded so the efficiency number
            # carries its own error bar on this shared 2-vCPU host.
            for w in (1, 2):
                times = []
                for _ in range(5):
                    t0 = time.perf_counter()
                    sblob = multihost.compress_windows_multihost(
                        sl, zt.FLAG_GZIP_FRAMING, workers=w
                    )
                    times.append(time.perf_counter() - t0)
                dt = min(times)
                if single is None:
                    single = (dt, sblob)
                scaling[f"windows_mode_{w}w_MBps"] = round(len(sl) / 1e6 / dt, 3)
                scaling[f"windows_mode_{w}w_MBps_spread"] = [
                    round(len(sl) / 1e6 / max(times), 3),
                    round(len(sl) / 1e6 / sorted(times)[len(times) // 2], 3),
                    round(len(sl) / 1e6 / min(times), 3),
                ]
                assert sblob == single[1], "windows mode diverged across workers"
            scaling["windows_mode_2w_efficiency"] = round(
                single[0] / (2 * dt), 3
            )
        except Exception as exc:  # pragma: no cover
            scaling = {"scaling_error": str(exc)[:120]}

    # BASELINE config-5 scale artifact: a large corpus through REAL
    # jax.distributed windows mode at 2 and 4 processes (gloo CPU
    # collectives; each process plans its span, psums its corpus
    # histogram, host 0 combines checksums and stitches). Subprocesses —
    # must also run before this process opens a GPU.
    dist_metrics = {}
    if os.environ.get("BENCH_DIST", "1") != "0":
        try:
            dist_bytes = int(os.environ.get("BENCH_DIST_BYTES", 256 << 20))
            for nproc in (1, 2, 4):
                out = subprocess.run(
                    [sys.executable, str(Path(__file__).parent / "scripts" /
                                          "bench_distributed.py"),
                     str(dist_bytes), str(nproc)],
                    check=True, capture_output=True, text=True,
                ).stdout.strip().splitlines()[-1]
                d = json.loads(out)
                assert d["roundtrip_ok"] and d["crc_combined_ok"], d
                dist_metrics[f"dist_{nproc}p_MBps"] = d["MBps"]
                dist_metrics[f"dist_{nproc}p_wall_s"] = d["wall_s"]
            dist_metrics["dist_bytes"] = dist_bytes
            # 2-proc efficiency vs the MATCHED 1-process jax.distributed
            # baseline; 4-proc is recorded for the decomposition only.
            dist_metrics["dist_2p_efficiency"] = round(
                dist_metrics["dist_2p_MBps"]
                / (2 * dist_metrics["dist_1p_MBps"]), 3
            )
        except Exception as exc:  # pragma: no cover
            dist_metrics = {"dist_error": str(exc)[:160]}

    # The composed full-device begin-phase (engine "jaxdev": device match
    # tables -> device splitter -> device block planner/DP/Huffman/token
    # emission; host does framing + the ordered bit splice) on a slice,
    # byte-compared against the native engine at the same block size,
    # with host-fallback accounting for degenerate staircase segments.
    jax_metrics = {}
    if os.environ.get("BENCH_JAX", "1") != "0":
        try:
            from zultra_tpu import engine as engine_mod
            from zultra_tpu.device import enable_compile_cache

            enable_compile_cache()
            from zultra_tpu.ops.matchfinder_jax import FALLBACK_STATS

            jslice = corpus[: 2 << 20]
            jbs = 131072  # device-kernel-sized blocks (buckets batch 8+ lanes)
            expect = zt.compress(jslice, zt.FLAG_GZIP_FRAMING, jbs)
            prev_engine = zt.get_engine()
            engine_mod.set_engine("jaxdev")
            try:
                # Warm at the MEASURED shape — batch kernels key on the
                # window-batch size, so a smaller warm slice would leave
                # the real shapes cold.
                zt.compress(jslice, zt.FLAG_GZIP_FRAMING, jbs)
                FALLBACK_STATS["segments"] = FALLBACK_STATS["overflowed"] = 0
                t0 = time.perf_counter()
                jblob = zt.compress(jslice, zt.FLAG_GZIP_FRAMING, jbs)
                jax_elapsed = time.perf_counter() - t0
            finally:
                engine_mod._active_engine = prev_engine
            segs = max(FALLBACK_STATS["segments"], 1)
            jax_metrics = {
                "jaxdev_engine_slice_MBps": round(len(jslice) / 1e6 / jax_elapsed, 3),
                "jaxdev_engine_parity": 0 if jblob == expect else 1,
                "jax_engine_host_fallback_pct": round(
                    100.0 * FALLBACK_STATS["overflowed"] / segs, 2
                ),
            }

            # Streamed jaxdev: the SAME slice pushed
            # through Stream in 16 KB chunks — the queued batched
            # begin-phase must hold the one-shot rate (bar: within 1.2x).
            engine_mod.set_engine("jaxdev")
            try:
                from zultra_tpu.stream import CONTINUE, FINALIZE, Stream

                def stream_once():
                    st = Stream(zt.FLAG_GZIP_FRAMING, jbs)
                    parts = []
                    for off in range(0, len(jslice), 16384):
                        chunk = jslice[off : off + 16384]
                        last = off + 16384 >= len(jslice)
                        parts.append(
                            st.compress(chunk, FINALIZE if last else CONTINUE)
                        )
                    return b"".join(parts)

                sblob = stream_once()  # warm the queued-path shapes
                t0 = time.perf_counter()
                sblob = stream_once()
                s_elapsed = time.perf_counter() - t0
            finally:
                engine_mod._active_engine = prev_engine
            jax_metrics["jaxdev_stream_MBps"] = round(
                len(jslice) / 1e6 / s_elapsed, 3
            )
            jax_metrics["jaxdev_stream_parity"] = 0 if sblob == expect else 1
        except Exception as exc:  # pragma: no cover - report, don't fail
            jax_metrics = {"jax_engine_error": str(exc)[:120]}

    # Batched device SA vs host SA-IS: compute-side
    # MB/s at batch 8, bit-exact, on whatever chip is attached.
    sa_metrics = {}
    if os.environ.get("BENCH_SA", "1") != "0":
        try:
            import jax
            import jax.numpy as jnp
            import numpy as np

            from zultra_tpu import native
            from zultra_tpu.ops.suffix_jax import _doubling_rounds, _num_levels

            B, n = 8, 1 << 17
            wins = np.frombuffer(corpus[: B * n], dtype=np.uint8).reshape(B, n)
            host_t = time.perf_counter()
            host_sas = [native.suffix_array(w) for w in wins]
            host_t = time.perf_counter() - host_t

            levels = _num_levels(n)
            sa_fn = jax.jit(jax.vmap(lambda w: _doubling_rounds(w, n, levels, 8)[0]))
            dwins = jnp.asarray(wins.astype(np.int32))
            dev_sa = np.asarray(sa_fn(dwins))  # compile + warm + check
            ok = all(np.array_equal(dev_sa[i], host_sas[i]) for i in range(B))
            best = 1e9
            for _ in range(3):
                t0 = time.perf_counter()
                _ = np.asarray(sa_fn(dwins).sum())  # forced fetch, compute-side
                best = min(best, time.perf_counter() - t0)
            sa_metrics = {
                "device_sa_batch8_MBps": round(B * n / 1e6 / best, 2),
                "host_sais_MBps": round(B * n / 1e6 / host_t, 2),
                "device_sa_bitexact": bool(ok),
                "device_platform": jax.devices()[0].platform,
            }
        except Exception as exc:  # pragma: no cover
            sa_metrics = {"device_sa_error": str(exc)[:120]}

    result = {
        "metric": "text_corpus_gzip_compress_throughput_bitexact",
        "value": round(mbps, 3),
        "unit": "MB/s",
        "vs_baseline": round(mbps / BASELINE_MBPS, 3),
        "corpus_bytes": len(corpus),
        "compressed_bytes": len(blob),
        "ratio_pct": round(100.0 * len(blob) / len(corpus), 2),
        "parity_delta_bytes": parity_delta,
        "reference_same_host_MBps": round(ref_mbps, 3) if ref_mbps else None,
        "speedup_vs_reference_same_host": round(mbps / ref_mbps, 3) if ref_mbps else None,
        "engine": zt.get_engine().name,
        **mixed_metrics,
        **dist_metrics,
        **jax_metrics,
        **scaling,
        **sa_metrics,
    }
    print(json.dumps(result))
    return 0 if parity_delta in (0, None) else 1


if __name__ == "__main__":
    raise SystemExit(main())
