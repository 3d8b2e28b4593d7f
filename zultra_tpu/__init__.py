"""zultra_tpu — a near-optimal DEFLATE (RFC 1951/1950/1952) compression
framework with a host engine and a JAX device engine.

A from-scratch reimplementation of the capabilities of emmanuel-marty/zultra
for accelerators: suffix-array LCP-interval match finding, optimal-parse
cost DP, Moffat–Katajainen Huffman construction with Zopfli-style RLE table
optimization, entropy-drift block splitting, zlib-style streaming API with
preset dictionaries — producing output byte-for-byte identical to the
reference and decodable by stock zlib/gzip, scaling data-parallel over
windows, chips and hosts via jax.sharding.
"""

from .constants import (
    FLAG_DEFLATE_FRAMING,
    FLAG_GZIP_FRAMING,
    FLAG_ZLIB_FRAMING,
)
from .engine import get_engine, set_engine
from .stream import CONTINUE, FINALIZE, Stream, StreamError, compress, memory_bound

__version__ = "0.1.0"

__all__ = [
    "FLAG_DEFLATE_FRAMING",
    "FLAG_GZIP_FRAMING",
    "FLAG_ZLIB_FRAMING",
    "CONTINUE",
    "FINALIZE",
    "Stream",
    "StreamError",
    "compress",
    "memory_bound",
    "get_engine",
    "set_engine",
    "__version__",
]
