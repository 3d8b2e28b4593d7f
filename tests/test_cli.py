"""CLI surface tests (compress/verify/bench/self-test/dictionary)."""

import subprocess
import sys
import zlib
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def run_cli(args, cwd="/tmp"):
    env = {"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin", "HOME": "/root"}
    return subprocess.run(
        [sys.executable, "-m", "zultra_tpu.cli", *args],
        capture_output=True, text=True, cwd=cwd, env=env,
    )


def test_cli_compress_verify(tmp_path):
    src = REPO / "README.md"
    out = tmp_path / "out.gz"
    result = run_cli(["-v", "-c", "-gzip", str(src), str(out)])
    assert result.returncode == 0, result.stderr
    assert "verified OK" in result.stdout
    assert zlib.decompress(out.read_bytes(), 31) == src.read_bytes()


def test_cli_zlib_dictionary(tmp_path):
    src = REPO / "SURVEY.md"
    out = tmp_path / "out.zz"
    result = run_cli(["-zlib", "-D", str(src), "-c", str(src), str(out)])
    assert result.returncode == 0, result.stderr


def test_cli_dictionary_requires_zlib(tmp_path):
    result = run_cli(["-gzip", "-D", "x", str(REPO / "README.md"), str(tmp_path / "o")])
    assert result.returncode != 0
    assert "zlib" in result.stderr


def test_cli_quicktest():
    result = run_cli(["-quicktest"])
    assert result.returncode == 0, result.stderr
    assert "self-tests passed" in result.stdout


def test_cli_usage_error():
    result = run_cli([])
    assert result.returncode != 0
    assert "usage" in result.stderr


def test_cli_output_matches_reference_cli(ref_binary, lz_corpus_large, tmp_path):
    """File-level byte parity between the two CLIs (both feed the stream
    in 16 KB chunks; sizes chosen to straddle chunk and window edges)."""
    import subprocess as sp

    base = b"".join(lz_corpus_large.values())
    for size in (48944, 16384 * 3, 16384 * 3 + 1, 1048576 + 5, len(base)):
        data = base[:size]
        src = tmp_path / f"in_{size}.bin"
        src.write_bytes(data)
        ref_out = tmp_path / f"ref_{size}.gz"
        my_out = tmp_path / f"my_{size}.gz"
        sp.run([str(ref_binary), "-gzip", str(src), str(ref_out)],
               check=True, capture_output=True)
        result = run_cli(["-gzip", str(src), str(my_out)])
        assert result.returncode == 0, result.stderr
        assert my_out.read_bytes() == ref_out.read_bytes(), size


def test_cli_empty_input_clean_error(tmp_path):
    """An empty input file exits with a clean error, not a traceback."""
    inp = tmp_path / "empty.bin"
    inp.write_bytes(b"")
    out = tmp_path / "empty.gz"
    r = subprocess.run(
        [sys.executable, "-m", "zultra_tpu.cli", "-gzip", str(inp), str(out)],
        capture_output=True, text=True, cwd=Path(__file__).resolve().parent.parent,
    )
    assert r.returncode == 100
    assert "Traceback" not in r.stderr
    assert "error compressing" in r.stderr


def test_guarded_compress_real_buffer_and_injected_overrun():
    """-cbench guard semantics (reference tool/zultra.c:710-753): the
    guarded arena wraps the buffer the engines actually write into —
    clean runs keep the guards intact, and an injected bound-accounting
    bug (a bitwriter that believes the buffer is bigger than the guarded
    region) trips them."""
    import numpy as np
    import pytest

    from zultra_tpu import FLAG_GZIP_FRAMING, compress
    from zultra_tpu.cli import GUARD, GUARD_BYTE, compress_guarded
    from zultra_tpu.stream import Stream, clamp_block_size

    rng = np.random.default_rng(3)
    data = bytes(rng.integers(0, 8, 200_000, dtype=np.uint8))  # compressible

    out = compress_guarded(data, FLAG_GZIP_FRAMING)
    assert out == compress(data, FLAG_GZIP_FRAMING)

    # Injected overrun: hand the native window compressor a capacity
    # larger than the guarded region. Incompressible input forces stored
    # blocks that need ~in_size + 11 bytes; with the region cut short the
    # emitter's real writes land in the guard.
    import ctypes

    from zultra_tpu import native

    lib = native.get_lib()
    bad = np.ascontiguousarray(rng.integers(0, 256, 65536, dtype=np.uint8))
    region_size = 65540  # stored output needs 65536 + 11
    arena = bytearray(bytes([GUARD_BYTE]) * (GUARD + region_size + GUARD))
    region = np.frombuffer(memoryview(arena)[GUARD : GUARD + region_size],
                           dtype=np.uint8)
    bd = ctypes.c_uint32(0)
    bc = ctypes.c_int32(0)
    n = lib.zn_compress_window(
        bad, 0, len(bad), 1, region, region_size + 64,  # the injected lie
        ctypes.byref(bd), ctypes.byref(bc),
    )
    assert n > region_size  # the emitter believed the lie
    del region
    assert arena[GUARD + region_size :] != bytes([GUARD_BYTE]) * GUARD
    assert arena[:GUARD] == bytes([GUARD_BYTE]) * GUARD


def test_cli_jaxdev_one_shot_matches_native_stream(tmp_path):
    """With the jaxdev engine, the CLI routes whole files through the
    engine's one-shot compress_corpus (batched device begin-phase) —
    byte-identical to the native engine's chunked stream path."""
    src = REPO / "SURVEY.md"
    out_n = tmp_path / "n.gz"
    out_j = tmp_path / "j.gz"
    r1 = run_cli(["-gzip", str(src), str(out_n)])
    assert r1.returncode == 0, r1.stderr
    env_extra = {"ZULTRA_ENGINE": "jaxdev", "JAX_PLATFORMS": "cpu",
                 "JAX_COMPILATION_CACHE_DIR": "/tmp/zultra_jax_cache"}
    import subprocess, sys as _sys
    env = {"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin", "HOME": "/root",
           **env_extra}
    r2 = subprocess.run(
        [_sys.executable, "-m", "zultra_tpu.cli", "-gzip", str(src), str(out_j)],
        capture_output=True, text=True, cwd="/tmp", env=env,
    )
    assert r2.returncode == 0, r2.stderr
    assert out_n.read_bytes() == out_j.read_bytes()
