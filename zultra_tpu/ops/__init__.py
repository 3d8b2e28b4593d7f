"""Device compute stages (JAX/XLA, and one CUDA kernel) for the
parallelizable pipeline stages.

All kernels are cross-validated against the spec/native engines; outputs
are bit-identical (suffix arrays and PLCP are canonical; histograms and
checksums are exact integer math).

Modules:
  suffix_jax   — prefix-doubling suffix array + rank-table PLCP (jit)
  histogram    — token histograms (int32 one-hot sums)
  checksum     — Adler-32 as a pair of reductions with an associative
                 shard combine (psum-friendly); CRC-32 GF(2) combine
  parse_jax    — the optimal-parse cost DP as a lax.scan (reference-exact,
                 used for cross-validation and small blocks)
"""

from .suffix_jax import suffix_array_jax, plcp_jax
from .histogram import token_histogram_jax
from .checksum import adler32_jax, adler32_combine, crc32_combine
from .parse_jax import optimize_matches_jax

__all__ = [
    "suffix_array_jax",
    "plcp_jax",
    "token_histogram_jax",
    "adler32_jax",
    "adler32_combine",
    "crc32_combine",
    "optimize_matches_jax",
]
