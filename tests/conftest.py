"""Shared test fixtures.

Tests run on the CPU with a virtual 8-device mesh, so the sharding logic
is exercised without a card; ``JAX_PLATFORMS`` may name another platform
(the ``gpu``-marked tests run only on a card). The golden oracle is the
reference zultra binary/library, built once per session from
REFERENCE_DIR when that source tree is present (read-only; compiled
artifacts land in a temp cache); the oracle tests skip without it.
"""

import ctypes
import os
import shutil
import subprocess
import sys
from pathlib import Path

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()
import jax

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")

import numpy as np
import pytest

REPO_ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO_ROOT))

from zultra_tpu.device import enable_compile_cache  # noqa: E402

# The composed device kernels take tens of seconds to build on the CPU;
# the persistent cache keeps them across sessions.
enable_compile_cache()

REFERENCE_DIR = Path("/root/reference")
CACHE_DIR = Path("/tmp/zultra_ref_cache")


def _build_reference():
    """Build the reference CLI binary and a shared library exposing
    zultra_memory_compress for oracle use."""
    CACHE_DIR.mkdir(exist_ok=True)
    binary = CACHE_DIR / "zultra"
    shared = CACHE_DIR / "libzultra_ref.so"
    if binary.exists() and shared.exists():
        return binary, shared

    build_dir = CACHE_DIR / "src"
    if not build_dir.exists():
        shutil.copytree(REFERENCE_DIR, build_dir)
    subprocess.run(["make", "-j4"], cwd=build_dir, check=True, capture_output=True)
    shutil.copy(build_dir / "zultra", binary)

    srcs = [
        str(p)
        for p in (build_dir / "src").rglob("*.c")
        if "divsufsort_utils" not in p.name and "examples" not in p.parts
    ]
    subprocess.run(
        ["gcc", "-O2", "-shared", "-fPIC", "-DNDEBUG",
         "-I", str(build_dir / "src"), "-o", str(shared)] + srcs,
        check=True, capture_output=True,
    )
    return binary, shared


def _require_reference():
    if not REFERENCE_DIR.is_dir():
        pytest.skip(f"reference source tree {REFERENCE_DIR} is absent")


@pytest.fixture(scope="session")
def ref_binary():
    _require_reference()
    binary, _ = _build_reference()
    return binary


class RefLib:
    """ctypes wrapper over the reference library's one-shot API, allowing
    arbitrary block sizes and preset dictionaries."""

    def __init__(self, shared_path):
        self.lib = ctypes.CDLL(str(shared_path))
        self.lib.zultra_memory_bound.restype = ctypes.c_size_t
        self.lib.zultra_memory_bound.argtypes = [ctypes.c_size_t, ctypes.c_uint, ctypes.c_uint]

    def compress(self, data: bytes, flags: int, max_block_size: int = 0,
                 dictionary: bytes | None = None) -> bytes:
        if dictionary is not None:
            return self._compress_stream_dict(data, flags, max_block_size, dictionary)
        bound = self.lib.zultra_memory_bound(len(data), flags, max_block_size)
        out = ctypes.create_string_buffer(bound)
        self.lib.zultra_memory_compress.restype = ctypes.c_size_t
        self.lib.zultra_memory_compress.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_uint, ctypes.c_uint,
        ]
        n = self.lib.zultra_memory_compress(data, len(data), out, bound, flags, max_block_size)
        if n == ctypes.c_size_t(-1).value:
            raise RuntimeError("reference compression failed")
        return out.raw[:n]

    def _compress_stream_dict(self, data, flags, max_block_size, dictionary):
        # zultra_stream_t layout: next_in(ptr), avail_in(size_t),
        # total_in(longlong), next_out(ptr), avail_out(size_t),
        # total_out(longlong), adler(uint), state(ptr),
        # zalloc(ptr), zfree(ptr), opaque(ptr)
        class Stream(ctypes.Structure):
            _fields_ = [
                ("next_in", ctypes.c_void_p), ("avail_in", ctypes.c_size_t),
                ("total_in", ctypes.c_longlong),
                ("next_out", ctypes.c_void_p), ("avail_out", ctypes.c_size_t),
                ("total_out", ctypes.c_longlong),
                ("adler", ctypes.c_uint),
                ("state", ctypes.c_void_p),
                ("zalloc", ctypes.c_void_p), ("zfree", ctypes.c_void_p),
                ("opaque", ctypes.c_void_p),
            ]

        lib = self.lib
        strm = Stream()
        ctypes.memset(ctypes.byref(strm), 0, ctypes.sizeof(strm))
        rc = lib.zultra_stream_init(ctypes.byref(strm), flags, max_block_size)
        assert rc == 0, rc
        if dictionary:
            rc = lib.zultra_stream_set_dictionary(
                ctypes.byref(strm), dictionary, len(dictionary))
            assert rc == 0
        bound = lib.zultra_memory_bound(len(data), flags, max_block_size) + len(dictionary or b"") + 64
        inbuf = ctypes.create_string_buffer(data, len(data))
        outbuf = ctypes.create_string_buffer(bound)
        strm.next_in = ctypes.cast(inbuf, ctypes.c_void_p)
        strm.avail_in = len(data)
        strm.next_out = ctypes.cast(outbuf, ctypes.c_void_p)
        strm.avail_out = bound
        rc = lib.zultra_stream_compress(ctypes.byref(strm), 1)
        lib.zultra_stream_end(ctypes.byref(strm))
        assert rc == 1, f"expected ZULTRA_STREAM_END, got {rc}"  # 1 == STREAM_END
        return outbuf.raw[: bound - strm.avail_out]


@pytest.fixture(scope="session")
def ref_lib():
    _require_reference()
    _, shared = _build_reference()
    return RefLib(shared)


@pytest.fixture
def gpu():
    """The first device, when it is a GPU; tests marked ``gpu`` take this
    fixture and skip anywhere else."""
    device = jax.devices()[0]
    if device.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's first device is {device.platform}")
    return device


# An in-repo C++ source file: real program text for the corpora.
SOURCE_TEXT = REPO_ROOT / "zultra_tpu" / "native" / "src" / "zultra_native.cpp"


def generate_lz_data(rng: np.random.RandomState, size: int, n_literals: int,
                     match_probability: float) -> bytes:
    """LZ-structured test data in the spirit of the reference self-test
    generator (tool/zultra.c:425-463)."""
    buf = bytearray()
    if size == 0:
        return bytes(buf)
    buf.append(int(rng.randint(n_literals)))
    while len(buf) < size:
        if rng.random_sample() >= match_probability:
            count = min(int(rng.randint(128)), size - len(buf))
            buf.extend(int(x) for x in rng.randint(0, n_literals, count))
        else:
            length = min(3 + int(rng.randint(1024)), size - len(buf), len(buf))
            offset = 1 + int(rng.randint(len(buf)))
            for _ in range(length):
                buf.append(buf[-offset])
    return bytes(buf)


def _make_corpus(sizes):
    rng = np.random.RandomState(12345)
    corpus = {}
    for size in sizes:
        for n_lit, prob in ((256, 0.2), (32, 0.6), (3, 0.9), (256, 0.0)):
            corpus[f"lz_{size}_{n_lit}_{prob}"] = generate_lz_data(rng, size, n_lit, prob)
    corpus["random_32k"] = rng.bytes(32768)
    corpus["zeros_16k"] = bytes(16384)
    corpus["source_code"] = SOURCE_TEXT.read_bytes()[:40000]
    return corpus


@pytest.fixture(scope="session")
def lz_corpus():
    """Small corpus; fast enough for the pure-Python spec engine."""
    return _make_corpus((4096, 16384))


@pytest.fixture(scope="session")
def lz_corpus_large():
    """Larger corpus for the native/jax engines (marked slow with spec)."""
    return _make_corpus((4096, 16384, 65536, 262144))
