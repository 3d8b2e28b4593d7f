"""Command-line tool, mirroring the reference CLI surface
(tool/zultra.c:778-935):

    python -m zultra_tpu.cli [-gzip|-zlib|-deflate] [-v] [-D dict]
                             [-c|-cbench|-test|-quicktest] <in> [out]

* default     — streaming file compression (16 KB chunks, like the CLI)
* -c          — verify after compress: re-inflate with stock zlib and
                compare against the original (tool/zultra.c:241-421)
* -cbench     — in-memory benchmark, best of 5 runs, with guard bytes
                around the output buffer (tool/zultra.c:645-774)
* -test/-quicktest — randomized self-test sweep: generated LZ data across
                sizes × alphabet sizes × match probabilities, compressed
                and re-inflated with stock zlib (tool/zultra.c:465-641)
"""

from __future__ import annotations

import sys
import time
import zlib

import numpy as np

from . import (
    CONTINUE,
    FINALIZE,
    FLAG_DEFLATE_FRAMING,
    FLAG_GZIP_FRAMING,
    FLAG_ZLIB_FRAMING,
    Stream,
    compress,
    memory_bound,
)
from .constants import HISTORY_SIZE

CHUNK_SIZE = 16384


def _load_dictionary(path: str) -> bytes:
    data = open(path, "rb").read()
    return data[-HISTORY_SIZE:]


def _decompress(blob: bytes, flags: int, dictionary: bytes | None = None) -> bytes:
    if flags & FLAG_GZIP_FRAMING:
        return zlib.decompress(blob, 15 + 16)
    if flags & FLAG_ZLIB_FRAMING:
        if dictionary:
            d = zlib.decompressobj(15, zdict=dictionary)
            return d.decompress(blob) + d.flush()
        return zlib.decompress(blob, 15)
    return zlib.decompress(blob, -15)


def do_compress(in_path: str, out_path: str, flags: int, dictionary: bytes | None,
                verbose: bool, verify: bool) -> int:
    from .engine import get_engine
    from .stream import StreamError

    start = time.perf_counter()

    if hasattr(get_engine(), "compress_corpus"):
        # Engines with a one-shot corpus path (jaxdev: windows batched
        # through the composed device begin-phase) compress whole files
        # through it — byte-identical to the chunked stream at the same
        # block size, without paying per-window begin latency (reference
        # one-shot API src/libzultra.c:601-619).
        data = open(in_path, "rb").read()
        try:
            blob = compress(data, flags, dictionary=dictionary)
        except StreamError as exc:
            print(f"error compressing '{in_path}': {exc}", file=sys.stderr)
            return 100
        open(out_path, "wb").write(blob)
        elapsed = time.perf_counter() - start
        if verbose:
            speed = (len(data) / 1048576.0) / max(elapsed, 1e-9)
            ratio = len(blob) * 100.0 / max(len(data), 1)
            print(
                f"Compressed '{in_path}' in {elapsed:.3f} seconds, "
                f"{speed:.2f} MB/s, {len(data)} into {len(blob)} bytes "
                f"==> {ratio:.2f} %"
            )
        if verify:
            if _decompress(blob, flags, dictionary) != data:
                print("verify FAILED: decompressed data differs", file=sys.stderr)
                return 100
            if verbose:
                print("Compressed data verified OK")
        return 0

    stream = Stream(flags)
    if dictionary:
        stream.set_dictionary(dictionary)

    total_in = 0
    with open(in_path, "rb") as fin, open(out_path, "wb") as fout:
        while True:
            chunk = fin.read(CHUNK_SIZE)
            finalize = FINALIZE if len(chunk) < CHUNK_SIZE else CONTINUE
            try:
                fout.write(stream.compress(chunk, finalize))
            except StreamError as exc:
                # e.g. empty input: the reference CLI errors out cleanly too.
                print(f"error compressing '{in_path}': {exc}", file=sys.stderr)
                return 100
            total_in += len(chunk)
            if verbose and not finalize and stream.total_out >= 1024 and total_in % (64 * CHUNK_SIZE) == 0:
                ratio = stream.total_out * 100.0 / max(stream.total_in, 1)
                print(f"\r{stream.total_in} => {stream.total_out} ({ratio:.1f} %)   ", end="", flush=True)
            if finalize:
                if verbose:
                    print("\r", end="")
                break
    elapsed = time.perf_counter() - start

    if verbose:
        speed = (total_in / 1048576.0) / max(elapsed, 1e-9)
        ratio = stream.total_out * 100.0 / max(total_in, 1)
        print(
            f"Compressed '{in_path}' in {elapsed:.3f} seconds, {speed:.2f} MB/s, "
            f"{total_in} into {stream.total_out} bytes ==> {ratio:.2f} %"
        )

    if verify:
        original = open(in_path, "rb").read()
        blob = open(out_path, "rb").read()
        if _decompress(blob, flags, dictionary) != original:
            print("verify FAILED: decompressed data differs", file=sys.stderr)
            return 100
        if verbose:
            print("Compressed data verified OK")
    return 0


GUARD = 1024
GUARD_BYTE = 0xAA


def compress_guarded(data: bytes, flags: int, max_block_size: int = 0) -> bytes:
    """One in-memory compression run through a guarded output arena: the
    stream's per-window output buffer — the memory every engine's emitter
    actually writes into — is a view between two guard regions, so a real
    buffer overrun corrupts the guards (reference tool/zultra.c:710-753
    semantics, adapted to the per-window buffer model). Raises
    RuntimeError when a guard trips."""
    from .stream import Stream, clamp_block_size

    mbs = clamp_block_size(max_block_size)
    out_cap = 1 + mbs + (1 + 4) * ((mbs // 65535) + 1)
    arena = bytearray(bytes([GUARD_BYTE]) * (GUARD + out_cap + GUARD))
    region = memoryview(arena)[GUARD : GUARD + out_cap]
    stream = Stream(flags, mbs, out_buffer=region)
    out = stream.compress(data, 1)
    del region
    if (arena[:GUARD] != bytes([GUARD_BYTE]) * GUARD
            or arena[GUARD + out_cap:] != bytes([GUARD_BYTE]) * GUARD):
        raise RuntimeError("guard bytes corrupted")
    return out


def do_benchmark(in_path: str, flags: int, verbose: bool) -> int:
    data = open(in_path, "rb").read()

    best = None
    comp = b""
    for run in range(5):
        t0 = time.perf_counter()
        try:
            comp = compress_guarded(data, flags)
        except RuntimeError as exc:
            print(str(exc), file=sys.stderr)
            return 100
        elapsed = time.perf_counter() - t0
        best = elapsed if best is None else min(best, elapsed)
        if verbose:
            print(f"run {run}: {len(data)/1048576.0/elapsed:.2f} MB/s")

    if _decompress(comp, flags) != data:
        print("roundtrip FAILED", file=sys.stderr)
        return 100
    print(
        f"compressed size: {len(comp)} bytes ({len(comp)*100.0/max(len(data),1):.2f} %), "
        f"best {len(data)/1048576.0/best:.2f} MB/s"
    )
    return 0


def generate_compressible_data(rng: np.random.RandomState, size: int,
                               n_literals: int, match_probability: float) -> bytes:
    buf = bytearray()
    if size == 0:
        return b""
    buf.append(int(rng.randint(n_literals)))
    while len(buf) < size:
        if rng.random_sample() >= match_probability:
            count = min(int(rng.randint(128)), size - len(buf))
            buf.extend(int(x) for x in rng.randint(0, n_literals, max(count, 0)))
        else:
            length = min(3 + int(rng.randint(1024)), size - len(buf), len(buf))
            offset = 1 + int(rng.randint(len(buf)))
            for _ in range(length):
                buf.append(buf[-offset])
    return bytes(buf)


def do_self_test(quick: bool, verbose: bool) -> int:
    rng = np.random.RandomState(123)
    flags = FLAG_ZLIB_FRAMING

    # Tiny-buffer / tiny-input probes must fail or succeed cleanly.
    for i in range(12):
        data = generate_compressible_data(rng, i, 256, 0.5)
        try:
            compress(data, flags)
        except Exception:
            pass

    sizes = [4096] if quick else [4096, 16384, 65536, 4 * HISTORY_SIZE]
    alphabets = [1, 2, 3, 15, 30, 56, 96, 137, 178, 191, 255, 256]
    probs = [0.0, 0.1, 0.3, 0.5, 0.7, 0.9, 0.995]
    n_tests = 0
    for size in sizes:
        for n_lit in alphabets:
            for prob in probs if not quick else probs[::2]:
                data = generate_compressible_data(rng, size, n_lit, prob)
                blob = compress(data, flags)
                if zlib.decompress(blob) != data:
                    print(
                        f"FAILED: size={size} alphabet={n_lit} p={prob}",
                        file=sys.stderr,
                    )
                    return 100
                n_tests += 1
                if verbose and n_tests % 20 == 0:
                    print(f"{n_tests} tests passed...")
    print(f"All {n_tests} self-tests passed")
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    flags = FLAG_GZIP_FRAMING
    verbose = False
    verify = False
    bench = False
    self_test = quick_test = False
    dict_path = None
    positional = []

    i = 0
    while i < len(argv):
        arg = argv[i]
        if arg == "-gzip":
            flags = FLAG_GZIP_FRAMING
        elif arg == "-zlib":
            flags = FLAG_ZLIB_FRAMING
        elif arg == "-deflate":
            flags = FLAG_DEFLATE_FRAMING
        elif arg == "-v":
            verbose = True
        elif arg == "-c":
            verify = True
        elif arg == "-cbench":
            bench = True
        elif arg == "-test":
            self_test = True
        elif arg == "-quicktest":
            quick_test = True
        elif arg == "-D":
            i += 1
            dict_path = argv[i]
        elif arg.startswith("-"):
            print(f"unknown option {arg}", file=sys.stderr)
            return 100
        else:
            positional.append(arg)
        i += 1

    if self_test or quick_test:
        return do_self_test(quick_test, verbose)

    if dict_path is not None and not (flags & FLAG_ZLIB_FRAMING):
        print("dictionaries are only supported with zlib framing", file=sys.stderr)
        return 100

    if bench:
        if len(positional) < 1:
            print("usage: zultra_tpu -cbench <infile>", file=sys.stderr)
            return 100
        return do_benchmark(positional[0], flags, verbose)

    if len(positional) != 2:
        print(
            "usage: python -m zultra_tpu.cli [-gzip|-zlib|-deflate] [-v] "
            "[-D dict] [-c|-cbench|-test|-quicktest] <infile> <outfile>",
            file=sys.stderr,
        )
        return 100

    dictionary = _load_dictionary(dict_path) if dict_path else None
    return do_compress(positional[0], positional[1], flags, dictionary, verbose, verify)


if __name__ == "__main__":
    raise SystemExit(main())
