"""Codec configuration: compression levels -> matcher effort.

Mirrors the level semantics of the reference-class codec (zlib's
configuration_table shape, SURVEY.md Appendix B), re-expressed for the
sort-based matcher: zlib ramps effort by walking longer hash chains
(`chain` 4 -> 4096); here the equivalents are `candidates` (how many
sorted-neighbor suffixes are scored per position) and `key_words` (how
many u32 words of suffix prefix the sort orders by — deeper keys rank
large equal-prefix groups exactly, which is what long chain walks buy).
`max_lazy`/`nice` keep zlib's lazy-deferral semantics.
"""
from __future__ import annotations

import dataclasses

DEFAULT_CHUNK_BYTES = 1 << 18  # 256 KiB window-aligned shards
WINDOW_BYTES = 1 << 15


@dataclasses.dataclass(frozen=True)
class LevelParams:
    level: int
    lazy_mode: bool  # False = greedy commit, True = one-byte-defer
    max_lazy: int
    nice: int
    # Device matcher parameters (static): number of sorted-neighbor candidates
    # scored per position, and suffix-sort key depth in u32 words
    # (4 = 16-byte keys, 16 = 64-byte true-suffix order).
    candidates: int
    key_words: int
    # Cost-aware shortest-bit-path parse (native C DP over the device
    # matcher's candidates) — the level-9 effort ramp beyond lazy
    # matching (SURVEY.md Appendix B's chain-4096 analogue).
    optimal: bool = False


# level -> params; level 0 is stored-only (handled in the container layer).
LEVELS: dict[int, LevelParams] = {
    1: LevelParams(1, False, 4, 8, 4, 4),
    2: LevelParams(2, False, 5, 16, 6, 4),
    3: LevelParams(3, False, 6, 32, 8, 4),
    4: LevelParams(4, True, 4, 16, 8, 8),
    5: LevelParams(5, True, 16, 32, 12, 8),
    6: LevelParams(6, True, 16, 128, 16, 16),
    7: LevelParams(7, True, 32, 128, 20, 16, optimal=True),
    8: LevelParams(8, True, 128, 258, 24, 16, optimal=True),
    9: LevelParams(9, True, 258, 258, 32, 16, optimal=True),
}

# Encoding strategies (zlib.h:196-200 contract).
STRATEGY_DEFAULT = 0
STRATEGY_FILTERED = 1
STRATEGY_HUFFMAN_ONLY = 2
STRATEGY_RLE = 3
STRATEGY_FIXED = 4


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    level: int = 6
    format: str = "zlib"  # zlib | gzip | raw
    chunk_bytes: int = DEFAULT_CHUNK_BYTES
    window_bits: int = 15
    strategy: int = STRATEGY_DEFAULT
    # zlib's memLevel (zlib.h:581-585) trades memory for speed via hash
    # table sizing; the analogue here is the per-dispatch device-memory
    # budget: each step down from 8 halves the chunk-batch HBM footprint
    # (api._device_batch), 9 doubles it.
    mem_level: int = 8

    def __post_init__(self):
        if self.level not in range(0, 10):
            raise ValueError(f"level must be 0..9, got {self.level}")
        if self.format not in ("zlib", "gzip", "raw"):
            raise ValueError(f"unknown format {self.format!r}")
        if not 8 <= self.window_bits <= 15:
            raise ValueError("window_bits must be 8..15")
        if self.chunk_bytes < 1024 or self.chunk_bytes % 1024:
            raise ValueError("chunk_bytes must be a multiple of 1024")
        if not 1 <= self.mem_level <= 9:
            raise ValueError("mem_level must be 1..9")

    @property
    def params(self) -> LevelParams:
        return LEVELS[max(1, self.level)]
