"""Public one-shot API: compress / decompress (SURVEY.md L6).

Shape of the API follows the whole-buffer model (libdeflate.h:71-137 is the
contract template; zlib.h:1229 compress2 the classic one): bytes in, bytes
out, with level/format/dictionary options. The streaming API lives in
zzflate_tpu.stream; the multi-device pipeline in zzflate_tpu.parallel.
"""
from __future__ import annotations

import os
import zlib as _zlib

import numpy as np

from zzflate_tpu import config as cfg_mod
from zzflate_tpu.config import CodecConfig
from zzflate_tpu.native import adler32 as _nadler32, crc32 as _ncrc32
from zzflate_tpu.models import deflate_encoder, inflate
from zzflate_tpu.utils import containers

_WINDOW = 32768


def compress_bound(n: int, format: str = "zlib") -> int:
    """Worst-case compressed size (stored fallback bound), zlib.h:760 shape."""
    overhead = {"raw": 0, "zlib": 2 + 4 + 4, "gzip": 10 + 8}[format]
    return n + 5 * (n // 65535 + 1) + 2 + overhead


# The batched two-phase device pipeline lives in encode_pipeline
# (mechanism) + encode_policy (stitching/parse policy); this alias keeps
# the historical internal entry point for stream/parallel/resume callers.
from zzflate_tpu.encode_pipeline import (  # noqa: E402
    build_chunk_batch as _build_chunk_batch,
    encode_segments as _encode_segments,
)


def compress(
    data: bytes,
    level: int = 6,
    format: str = "zlib",
    dictionary: bytes | None = None,
    chunk_bytes: int = cfg_mod.DEFAULT_CHUNK_BYTES,
    strategy: int = cfg_mod.STRATEGY_DEFAULT,
    indexed: bool = False,
    window_bits: int = 15,
    mem_level: int = 8,
    engine: str = "tpu",
    seekable: bool = False,
) -> bytes:
    """One-shot compress to a zlib/gzip/raw stream (decodable by zlib).

    indexed=True (gzip only) adds a 'ZZ' FEXTRA subfield with the
    per-chunk compressed sizes; the stream stays a plain gzip member for
    every standard reader, while our device inflate uses the index for
    chunk-parallel decode (models/inflate_tpu.py). window_bits 8..15
    bounds match distances to 2^window_bits (zlib.h:551-556 contract).

    seekable=True (requires indexed) additionally resets the LZ window
    at every chunk boundary (Z_FULL_FLUSH semantics per chunk, at the
    usual ~0.3% ratio cost): any chunk then decodes from its own
    segment alone, and decompress_range() serves random-access reads
    touching only the covering chunks (bgzip-style seekable gzip).

    engine="tpu" (default) runs the device pipeline; engine="native"
    runs the one-shot C encoder (native/zzflate_native.c zzt_deflate) —
    the host-side serving path for payloads where a device dispatch is
    all latency. The native engine covers levels 0-9, all strategies,
    formats, window_bits and dictionaries; indexed output requires the
    device pipeline.
    """
    data = bytes(data)
    config = CodecConfig(
        level=level, format=format, chunk_bytes=chunk_bytes,
        strategy=strategy, window_bits=window_bits, mem_level=mem_level,
    )
    if dictionary is not None and format == "gzip":
        raise ValueError("gzip streams cannot carry a preset dictionary")
    if indexed and format != "gzip":
        raise ValueError("indexed output requires format='gzip'")
    if engine not in ("tpu", "native"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "native" and indexed:
        raise ValueError("indexed output requires engine='tpu'")
    if seekable and not indexed:
        raise ValueError("seekable output requires indexed=True")
    if indexed and level == 0:
        # Level 0 is one whole-stream stored run (no per-chunk segments
        # to index); rejecting beats silently emitting an unindexed
        # stream with the indexed/seekable promise dropped.
        raise ValueError("indexed output requires level >= 1")

    segments: list[bytes] | None = None
    if level == 0:
        payload = containers.stored_segment(data, final=True)
    elif engine == "native":
        from zzflate_tpu import native as _native

        # Chunk-parallel above 1 MiB (window-aligned halo chunks on a
        # thread pool, sync-flush stitched — the host mirror of the
        # device pipeline's DP axis); single-shot below it.
        payload = _native.deflate_raw_mt(
            data, level=level, dictionary=dictionary or b"",
            max_dist=min(32768, 1 << config.window_bits), final=True,
            strategy=strategy,
            # The native engine's chunk granularity: at least 1 MiB (its
            # serving-path sweet spot), honoring larger explicit values.
            # Output bytes depend only on (data, parameters) — never on
            # this machine's core count (deflate_raw_mt contract).
            chunk_bytes=max(chunk_bytes, 1 << 20),
        )
        # Whole-stream stored fallback keeps the compress_bound contract
        # (the native encoder's per-64 KiB blocks each add ~10 framing
        # bytes on incompressible data; one whole-stream stored run is
        # the contract's worst case).
        stored_whole = containers.stored_segment(data, final=True)
        if len(stored_whole) < len(payload):
            payload = stored_whole
    else:
        enc = _encode_segments(
            data, config, dictionary, with_anchors=indexed,
            halo=not seekable,
        )
        segments = enc["segments"]
        payload = b"".join(segments)
        # Whole-stream stored fallback: per-chunk sync-flush framing adds
        # ~5 bytes/chunk, so incompressible inputs could otherwise exceed
        # compress_bound (which is chunking-independent by contract).
        # Indexed streams keep their per-chunk layout instead (the chunks
        # already fall back to stored blocks individually).
        if not indexed:
            stored_whole = containers.stored_segment(data, final=True)
            if len(stored_whole) < len(payload):
                payload = stored_whole
                segments = None

    if format == "raw":
        return payload
    if format == "zlib":
        dictid = _nadler32(dictionary) if dictionary is not None else None
        return (
            containers.zlib_header(level, dictid, config.window_bits)
            + payload
            + containers.zlib_trailer(_nadler32(data))
        )
    if indexed and segments is not None:
        hdr = containers.gzip_header_indexed(
            chunk_bytes,
            list(
                zip(
                    (len(s) for s in segments),
                    enc["blocks"],
                    enc["anchors"],
                )
            ),
            flags=containers.ZZ_FLAG_SEEKABLE if seekable else 0,
        )
    else:
        hdr = containers.gzip_header()
    return (
        hdr
        + payload
        + containers.gzip_trailer(_ncrc32(data), len(data))
    )


def decompress(
    data: bytes,
    format: str = "zlib",
    dictionary: bytes | None = None,
    engine: str = "native",
) -> bytes:
    """One-shot decompress (our own inflate; checksum-verified).

    engine="native" uses the C decoder (host); engine="tpu" decodes
    indexed gzip streams chunk-parallel on device (models/inflate_tpu),
    falling back to native for unindexed streams.
    """
    data = bytes(data)
    if engine == "tpu":
        from zzflate_tpu.models import inflate_tpu

        if format == "gzip":
            out = inflate_tpu.decompress_indexed(data)
            if out is not None:
                return out
        if dictionary is None:
            # Foreign (unindexed) streams: host anchor pre-scan feeds the
            # same device anchor-walk kernel (SURVEY.md C17 — arbitrary
            # zlib/gzip/raw input decodes chunk-parallel on device).
            out = inflate_tpu.decompress_foreign(data, format=format)
            if out is not None:
                return out
    return inflate.decompress(data, format=format, dictionary=dictionary)


def decompress_range(
    data: bytes, offset: int, length: int
) -> bytes:
    """Random-access read of [offset, offset+length) from an indexed gzip
    stream without decoding the whole member.

    Seekable streams (compress(..., indexed=True, seekable=True)) decode
    only the chunks covering the range; halo-encoded indexed streams
    decode the prefix chunks up to the range's end (still skipping the
    tail). Unindexed streams fall back to a full decode + slice.
    Checksums are NOT verified on partial reads (the gzip CRC covers the
    whole member); use decompress() for verified full reads.
    """
    import struct as _struct

    data = bytes(data)
    if offset < 0 or length < 0:
        raise ValueError("offset/length must be non-negative")
    parsed = containers.parse_gzip_index(data)
    if parsed is None:
        out = inflate.decompress(data, format="gzip")
        if offset + length > len(out):
            # Same contract as the indexed path below: out-of-range
            # reads raise instead of silently truncating.
            raise ValueError("range beyond the decoded stream")
        return out[offset : offset + length]
    header_len, chunk_bytes, _anchor_tokens, chunks = parsed
    member_len = header_len + sum(sz for sz, _b, _a in chunks) + 8
    if member_len > len(data):
        raise ValueError("indexed stream shorter than its index")
    (isize,) = _struct.unpack("<I", data[member_len - 4 : member_len])
    if offset + length > isize:
        raise ValueError("range beyond the decoded stream")
    if length == 0:
        return b""
    flags = containers.gzip_index_flags(data) or 0
    seekable = bool(flags & containers.ZZ_FLAG_SEEKABLE)

    from zzflate_tpu import native as _native

    c0 = offset // chunk_bytes
    c1 = min(len(chunks), -(-(offset + length) // chunk_bytes))
    lo = c0 if seekable else 0
    cpos = header_len
    starts = []
    for sz, _b, _a in chunks:
        starts.append(cpos)
        cpos += sz
    window = b""
    parts: list[bytes] = []
    for ci in range(lo, c1):
        seg = data[starts[ci] : starts[ci] + chunks[ci][0]]
        expect = min(chunk_bytes, isize - ci * chunk_bytes)
        if _native.lib() is not None:
            out, _bit, _fin, _more = _native.inflate_stream(
                seg, window=window, out_cap_hint=expect + 16
            )
        else:
            out, _bit, _fin, _more = inflate.inflate_blocks(
                seg, window, 0
            )
        if len(out) != expect:
            raise ValueError("indexed segment decoded to the wrong size")
        if not seekable:
            # The encode halo is the last 32 KiB of ALL prior data, which
            # can span several chunks when chunk_bytes < 32 KiB.
            window = (window + out)[-32768:]
        if ci >= c0:
            parts.append(out)
    blob = b"".join(parts)
    rel = offset - c0 * chunk_bytes
    return blob[rel : rel + length]
