"""The planner's cost DP as a CUDA kernel (ops/cuda/cost_dp.cu), called
through JAX's foreign function interface on the GPU.

Off the GPU the planner runs the XLA backward scan
(parse_wavefront._dp_scan_cost + _select_pass), which is also the
reference the kernel is compared with. The scan needs one loop trip per
8 positions; on a GPU every trip is a round of small kernel launches.
The kernel instead walks a block lane's positions inside one warp, with
the 259-deep cost ring in shared memory.

This module holds what surrounds the kernel and runs on any backend:
the packing of the per-position statics into the kernel's operands, the
unpacking of its choices, and the build of the shared library. The
library is compiled with ``nvcc`` for ``sm_90a`` from the committed
source on first use, into ``ops/cuda/build/`` (git-ignored); a failed
build raises, it never falls back to the scan on a GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp

from ..constants import MIN_MATCH_SIZE, NMATCHES_PER_OFFSET
from .parse_wavefront import INF, _prep

CUDA_DIR = Path(__file__).resolve().parent / "cuda"
SOURCE = CUDA_DIR / "cost_dp.cu"
BUILD_DIR = CUDA_DIR / "build"
TARGET = "zultra_cost_dp"
ARCH = "sm_90a"

# The kernel's packings are exact while every cost stays below 2^25:
# 15-bit codes at most over at most 2^21 positions (the reference's
# largest block, 2 MiB).
MAX_N = 1 << 21
CHUNK = 32  # positions the kernel stages per step; n must divide by it
VARLEN_SLOTS = 40  # truncations k = 3..39 plus padding
_VARLEN_PAD = 1 << 26

KIND_SHORT = 1
KIND_LONG = 2


def pack_lane(lit_lens, off_lens, window, mlens, moffs, length, n_pad: int):
    """One block lane's kernel operands from the same statics the scan
    uses (parse_wavefront._prep): ``lit`` (n_pad,) literal costs, 0
    beyond the block; ``slots`` (n_pad, 8) len | cost << 9 | kind << 16;
    ``varlen`` (40,) length-symbol bits of truncations 3..39."""
    (
        _, lit_cost, clamped, osize, long_cost_static, _, _, _, _, _,
        varlen_k,
    ) = _prep(lit_lens, off_lens, window, mlens, moffs, length, n_pad)
    is_long = long_cost_static < INF
    is_short = (mlens >= MIN_MATCH_SIZE) & ~is_long
    cost = jnp.where(is_long, long_cost_static, osize)
    kind = jnp.where(is_long, KIND_LONG, jnp.where(is_short, KIND_SHORT, 0))
    slots = jnp.where(kind > 0, clamped | (cost << 9) | (kind << 16), 0)
    pad = jnp.full((VARLEN_SLOTS - varlen_k.shape[0],), _VARLEN_PAD, jnp.int32)
    varlen = jnp.concatenate([varlen_k, pad])
    return lit_cost, slots.astype(jnp.int32), varlen


def pack_lanes(lit_lens, off_lens, window, mlens, moffs, length, n_pad: int):
    """``pack_lane`` over a batch of lanes: (B, n_pad), (B, n_pad, 8),
    (B, 40)."""
    if n_pad % CHUNK or not 0 < n_pad <= MAX_N:
        raise ValueError(
            f"n_pad={n_pad} must be a positive multiple of {CHUNK} "
            f"and at most {MAX_N}"
        )
    return jax.vmap(
        lambda a, b, c, d, e, f: pack_lane(a, b, c, d, e, f, n_pad)
    )(lit_lens, off_lens, window, mlens, moffs, length)


def unpack_choices(packed, moffs):
    """Kernel output (B, n) of len | slot << 9 → (best_len, best_off);
    the offset is the chosen slot's, selected without a gather."""
    best_len = packed & 511
    slot = packed >> 9
    best_off = jnp.zeros_like(best_len)
    for m in range(NMATCHES_PER_OFFSET):
        best_off = jnp.where(slot == m + 1, moffs[:, :, m], best_off)
    return best_len, best_off


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the cost-DP kernel cannot be built")


def _build_command(out: Path) -> list[str]:
    return [
        _nvcc(), "-gencode", f"arch=compute_90a,code={ARCH}",
        "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-I", jax.ffi.include_dir(), "-o", str(out), str(SOURCE),
    ]


def library_path() -> Path:
    """Where the build of the current source lives (keyed by its hash,
    so an edited source never loads a stale library)."""
    digest = hashlib.sha256(SOURCE.read_bytes() + ARCH.encode()).hexdigest()[:16]
    return BUILD_DIR / f"libzultra_cost_dp-{digest}.so"


def build_library() -> Path:
    """Compile the kernel library if this source has no build yet. The
    build writes a temporary file and renames it, so concurrent first
    uses never load a half-written library."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(_build_command(tmp), capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed building {SOURCE.name}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


_library = None


def register() -> None:
    """Build (first use only), load and register the FFI target."""
    global _library
    if _library is not None:
        return
    lib = ctypes.cdll.LoadLibrary(str(build_library()))
    jax.ffi.register_ffi_target(
        TARGET, jax.ffi.pycapsule(lib.ZultraCostDp), platform="CUDA"
    )
    _library = lib


def run_dp_cuda(lit_lens, off_lens, window, mlens, moffs, length, n_pad: int):
    """Batched DP with block_jax._run_dp's contract: (B, ...) inputs,
    returns (best_len, best_off), each (B, n_pad) int32."""
    register()
    lit, slots, varlen = pack_lanes(
        lit_lens, off_lens, window, mlens, moffs, length, n_pad
    )
    packed = jax.ffi.ffi_call(TARGET, jax.ShapeDtypeStruct(lit.shape, jnp.int32))(
        lit, slots, varlen
    )
    return unpack_choices(packed, moffs)
