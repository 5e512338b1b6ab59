"""zzflate_tpu: a DEFLATE/zlib/gzip codec whose hot paths run on device in JAX.

A from-scratch reimplementation of the reference (jandevaan/zzflate) codec
capability surface — LZ77 + Huffman deflate, inflate, zlib/gzip containers,
preset dictionaries, streaming flush — redesigned for accelerators:
vectorized candidate scoring instead of hash chains, row-parallel parse
sweeps instead of one serial commit loop, prefix-sum scatter
bit-packing, tree-combining checksums, and data-parallel chunk sharding
across device meshes.
"""
from zzflate_tpu.api import (compress, compress_bound, decompress,
                             decompress_range)
from zzflate_tpu.config import (
    STRATEGY_DEFAULT,
    STRATEGY_FILTERED,
    STRATEGY_FIXED,
    STRATEGY_HUFFMAN_ONLY,
    STRATEGY_RLE,
    CodecConfig,
)

__version__ = "0.1.0"

__all__ = [
    "compress",
    "decompress",
    "decompress_range",
    "compress_bound",
    "CodecConfig",
    "STRATEGY_DEFAULT",
    "STRATEGY_FILTERED",
    "STRATEGY_FIXED",
    "STRATEGY_HUFFMAN_ONLY",
    "STRATEGY_RLE",
    "__version__",
]
