"""DEFLATE format constants (RFC 1951/1950/1952).

All tables below are format facts verified against installed zlib 1.2.13 by
bit-level round-trip experiments (see SURVEY.md Appendix A). The reference
codec (jandevaan/zzflate) implements the identical contract; its mount was
empty at survey time, so the binding spec is BASELINE.json + the RFC
semantics pinned down in SURVEY.md A.1-A.6.
"""
from __future__ import annotations

import os

import numpy as np

MIN_MATCH = 3
MAX_MATCH = 258
WINDOW_SIZE = 32768

# 'ZZ' index v3 anchor spacing: the encoder records the (bit, output)
# position of every ANCHOR_TOKENS-th committed token inside a block, so
# the device decoder can walk every token interval in parallel with a
# static per-lane step bound (models/inflate_tpu.py). The decoder reads
# the spacing from the stream's index, so this knob only affects newly
# encoded indexed streams: halving it doubles decode lane parallelism
# (and halves the walk's serial step count) for ~2x the index overhead
# (~8 B per ANCHOR_TOKENS tokens). Env-tunable for A/B sweeps.
ANCHOR_TOKENS = int(os.environ.get("ZZFLATE_ANCHOR_TOKENS", "1024"))
if not 0 < ANCHOR_TOKENS <= 4096 or 65536 % ANCHOR_TOKENS:
    raise ValueError("ZZFLATE_ANCHOR_TOKENS must divide 65536 and be <= 4096")

# Literal/length alphabet: 0..255 literals, 256 end-of-block, 257..285 lengths.
NUM_LITLEN_SYMBOLS = 288  # 286 used + 2 reserved
NUM_DIST_SYMBOLS = 30  # 30 used (32 with reserved)
NUM_CL_SYMBOLS = 19
MAX_CODE_BITS = 15
MAX_CL_CODE_BITS = 7

# Length codes 257..285 -> (base length, extra bits). SURVEY.md A.2.
LENGTH_BASE = np.array(
    [3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31, 35, 43, 51, 59,
     67, 83, 99, 115, 131, 163, 195, 227, 258],
    dtype=np.int32,
)
LENGTH_EXTRA = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4,
     5, 5, 5, 5, 0],
    dtype=np.int32,
)

# Distance codes 0..29 -> (base distance, extra bits). SURVEY.md A.3.
DIST_BASE = np.array(
    [1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193, 257, 385, 513,
     769, 1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289, 16385, 24577],
    dtype=np.int32,
)
DIST_EXTRA = np.array(
    [0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10,
     11, 11, 12, 12, 13, 13],
    dtype=np.int32,
)

# Code-length alphabet transmission order. SURVEY.md A.4.
CL_ORDER = np.array(
    [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15],
    dtype=np.int32,
)

END_OF_BLOCK = 256


def _length_to_code_table() -> np.ndarray:
    """Map match length 3..258 -> length code index 0..28 (symbol-257)."""
    table = np.zeros(MAX_MATCH + 1, dtype=np.int32)
    for length in range(MIN_MATCH, MAX_MATCH + 1):
        # code 28 (symbol 285) encodes exactly 258; codes cover
        # [base, base + 2^extra - 1] otherwise.
        idx = int(np.searchsorted(LENGTH_BASE, length, side="right")) - 1
        table[length] = idx
    return table


LENGTH_TO_CODE = _length_to_code_table()


def dist_to_code(dist: int) -> int:
    """Distance 1..32768 -> distance code 0..29."""
    return int(np.searchsorted(DIST_BASE, dist, side="right")) - 1


def fixed_litlen_lengths() -> np.ndarray:
    """Fixed (BTYPE=1) literal/length code lengths. SURVEY.md A.5."""
    lengths = np.zeros(NUM_LITLEN_SYMBOLS, dtype=np.int32)
    lengths[0:144] = 8
    lengths[144:256] = 9
    lengths[256:280] = 7
    lengths[280:288] = 8
    return lengths


def fixed_dist_lengths() -> np.ndarray:
    """Fixed (BTYPE=1) distance code lengths: 5 bits for all 30 codes."""
    return np.full(NUM_DIST_SYMBOLS, 5, dtype=np.int32)


def canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """Canonical Huffman code assignment per RFC 1951 3.2.2 (host/numpy).

    Returns codes in natural (MSB-first) order; the bitstream writer must
    bit-reverse before LSB-first emission.
    """
    lengths = np.asarray(lengths, dtype=np.int32)
    max_len = int(lengths.max()) if lengths.size else 0
    bl_count = np.bincount(lengths, minlength=max_len + 1)
    bl_count[0] = 0
    next_code = np.zeros(max_len + 2, dtype=np.int64)
    code = 0
    for bits in range(1, max_len + 1):
        code = (code + int(bl_count[bits - 1])) << 1
        next_code[bits] = code
    codes = np.zeros_like(lengths)
    for sym in range(lengths.size):
        ln = int(lengths[sym])
        if ln > 0:
            codes[sym] = next_code[ln]
            next_code[ln] += 1
    return codes


def bit_reverse(codes: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Reverse the low `lengths` bits of each code (host/numpy)."""
    codes = np.asarray(codes, dtype=np.int64)
    lengths = np.asarray(lengths, dtype=np.int32)
    out = np.zeros_like(codes)
    for i in range(codes.size):
        c, n = int(codes[i]), int(lengths[i])
        r = 0
        for _ in range(n):
            r = (r << 1) | (c & 1)
            c >>= 1
        out[i] = r
    return out
