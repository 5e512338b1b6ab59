"""Device-parallel inflate (speculative bit decode + pointer doubling) vs the
zlib oracle, on indexed gzip streams produced by our encoder."""
import zlib

import numpy as np
import pytest

import zzflate_tpu as zf
from zzflate_tpu.models import inflate_tpu
from zzflate_tpu.utils import containers

CHUNK = 4096


def _roundtrip(data: bytes, level: int = 6) -> None:
    out = zf.compress(
        data, level=level, format="gzip", chunk_bytes=CHUNK, indexed=True
    )
    # Still a plain gzip member for standard readers.
    assert zlib.decompress(out, wbits=31) == data
    got = inflate_tpu.decompress_indexed(out)
    assert got == data


def test_text_multichunk():
    data = (b"speculative parallel decode " * 2000)[:40000]
    _roundtrip(data)


def test_cross_chunk_halo_references():
    # Period spans chunk boundaries: matches reach into the previous
    # chunk's output (resolved through the global parent graph).
    data = (b"0123456789abcdefgh" * 31)[:558] * 40
    _roundtrip(data)


def test_overlap_chains_rle():
    # dist=1 runs build the deepest parent chains (log-depth resolution).
    _roundtrip(b"\x00" * 50000)
    _roundtrip(b"ab" * 30000)


def test_stored_fallback_chunks():
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, size=30000, dtype=np.uint8).tobytes()
    _roundtrip(data)


def test_mixed_stored_and_coded():
    rng = np.random.default_rng(4)
    rnd = rng.integers(0, 256, size=CHUNK * 2, dtype=np.uint8).tobytes()
    text = b"compressible text region " * 400
    _roundtrip(rnd + text + rnd)


def test_small_and_empty():
    _roundtrip(b"")
    _roundtrip(b"x")
    _roundtrip(b"hello world")


@pytest.mark.parametrize("level", [1, 6, 9])
def test_levels(level):
    data = (b"level parametrized body " * 1500)[:30000]
    _roundtrip(data, level)


def test_multi_subblock_chunks_indexed():
    # chunk_bytes >= 2*64 KiB would normally split into sub-blocks; the
    # indexed contract forces one block per segment (regression: the
    # decoder parses exactly one header per segment).
    data = (b"multi sub-block indexed segment " * 9000)[: 260000]
    out = zf.compress(data, level=6, format="gzip", chunk_bytes=1 << 17,
                      indexed=True)
    assert zlib.decompress(out, wbits=31) == data
    assert inflate_tpu.decompress_indexed(out) == data


def test_boundary_crossing_matches_indexed():
    # Continuous real text: matches cross the 64 KiB sub-block bounds, so
    # later blocks' OUTPUT offsets are not multiples of the sub-block
    # size (regression: the index must carry the true cumulative offsets).
    import glob

    parts = []
    for p in sorted(glob.glob("/usr/include/*.h"))[:40]:
        try:
            parts.append(open(p, "rb").read())
        except OSError:
            pass
    data = b"".join(parts)[:260000]
    out = zf.compress(data, level=6, format="gzip", chunk_bytes=1 << 17,
                      indexed=True)
    assert zlib.decompress(out, wbits=31) == data
    assert inflate_tpu.decompress_indexed(out) == data


def test_unindexed_returns_none():
    blob = zf.compress(b"plain stream " * 100, level=6, format="gzip",
                       chunk_bytes=CHUNK)
    assert inflate_tpu.decompress_indexed(blob) is None


def test_index_parse_roundtrip():
    chunks = [
        (100, [(0, 0), (370, 1000)], [(95, 40), (180, 90)]),
        (200, [(0, 0)], []),
        (42, [], []),
    ]
    hdr = containers.gzip_header_indexed(CHUNK, chunks)
    parsed = containers.parse_gzip_index(hdr + b"\x00" * 8)
    assert parsed is not None
    hdr_len, cb, t, got = parsed
    assert hdr_len == len(hdr)
    assert cb == CHUNK
    assert t == containers.ANCHOR_TOKENS
    assert got == chunks


def test_corrupted_crc_detected():
    data = b"crc guarded " * 1000
    out = bytearray(
        zf.compress(data, level=6, format="gzip", chunk_bytes=CHUNK,
                    indexed=True)
    )
    out[-5] ^= 0x01  # flip a CRC bit
    with pytest.raises(ValueError):
        inflate_tpu.decompress_indexed(bytes(out))


def test_walk_nolut_matches_lut_path():
    """The LUT-free canonical walk decode (round 5) must be
    output-identical to the (U, 2^15) LUT path on a mixed stream
    (dynamic + fixed + stored chunks, matches crossing chunk seams)."""
    import jax

    rng = np.random.default_rng(9)
    data = (
        b"dyn text block " * 600
        + rng.integers(0, 256, CHUNK, dtype=np.uint8).tobytes()
        + b"ab"  # tiny tail chunk -> fixed tree
    )
    oi = zf.compress(data, level=6, format="gzip", chunk_bytes=CHUNK,
                     indexed=True)
    prev = inflate_tpu._WALK_NOLUT
    try:
        inflate_tpu._WALK_NOLUT = True
        jax.clear_caches()
        a = inflate_tpu.decompress_indexed(oi)
        inflate_tpu._WALK_NOLUT = False
        jax.clear_caches()
        b = inflate_tpu.decompress_indexed(oi)
    finally:
        inflate_tpu._WALK_NOLUT = prev
        jax.clear_caches()
    assert a == b == data


def test_multimember_with_indexed_first_member():
    # A valid gzip stream may append further members after the indexed
    # one; engine='tpu' must decode the indexed member from its own
    # extent (per the index) and the tail via the native path.
    a = b"indexed member payload " * 800
    b = b"appended plain member " * 300
    blob = zf.compress(a, level=6, format="gzip", chunk_bytes=CHUNK,
                       indexed=True)
    blob += zlib.compress(b, 6, wbits=31)
    # (zlib.decompress stops after one member; gzip.decompress is the
    # multi-member oracle.)
    import gzip as _gzip

    assert _gzip.decompress(blob) == a + b
    assert inflate_tpu.decompress_indexed(blob) == a + b
    assert zf.decompress(blob, format="gzip", engine="tpu") == a + b


def test_corrupted_index_block_count_no_crash():
    # An oversized nblocks u16 in the ZZ subfield must not escape as
    # struct.error: parse_gzip_index returns None (caller falls back).
    data = b"bounds checked " * 500
    blob = bytearray(
        zf.compress(data, level=6, format="gzip", chunk_bytes=CHUNK,
                    indexed=True)
    )
    # ZZ subfield body starts at offset 16 (10B header + XLEN + sid + slen);
    # the first chunk record's nblocks u16 sits at body offset 12+4
    # (v3 header: ver, flags, chunk_bytes, nchunks, anchor_tokens).
    body_off = 16
    nb_off = body_off + 12 + 4
    blob[nb_off : nb_off + 2] = (0xFFFF).to_bytes(2, "little")
    parsed = containers.parse_gzip_index(bytes(blob))
    assert parsed is None
    # decompress with engine='tpu' falls back to native; the stream body
    # is intact so it still decodes (FEXTRA content is not CRC-protected).
    assert zf.decompress(bytes(blob), format="gzip", engine="tpu") == data


def test_anchor_walk_long_blocks():
    # Literal-heavy data -> far more than ANCHOR_TOKENS tokens per
    # 64 KiB sub-block, so the v3 anchors (every ANCHOR_TOKENS-th
    # committed token) are load-bearing for the walk decoder, including
    # across merged sub-blocks and chunk halos.
    rng = np.random.default_rng(5)
    data = rng.integers(0, 16, size=400_000, dtype=np.uint8).tobytes()
    out = zf.compress(
        data, level=6, format="gzip", chunk_bytes=1 << 17, indexed=True
    )
    parsed = containers.parse_gzip_index(out)
    assert parsed is not None
    _hl, _cb, anchor_tokens, chunks = parsed
    assert anchor_tokens == containers.ANCHOR_TOKENS
    assert any(anchors for _s, _b, anchors in chunks)
    assert inflate_tpu.decompress_indexed(out) == data
    arr, n = inflate_tpu.decompress_indexed(out, to_device=True)
    assert n == len(data) and bytes(np.asarray(arr)) == data


def test_v2_index_back_compat():
    # Legacy v2 'ZZ' subfields (no anchors, no T field) must still parse
    # and decode through the per-bit speculative path.
    import struct

    data = (b"v2 back compat payload " * 3000)[:60000]
    out = zf.compress(data, level=6, format="gzip", chunk_bytes=CHUNK,
                      indexed=True)
    parsed = containers.parse_gzip_index(out)
    assert parsed is not None
    header_len, cb, _t, chunks = parsed
    # Rebuild the FEXTRA as a v2 subfield over the same body.
    sub = bytearray(struct.pack("<BBII", 2, 0, cb, len(chunks)))
    for seg_bytes, blocks, _anchors in chunks:
        sub += struct.pack("<IH", seg_bytes, len(blocks))
        for bit_off, out_off in blocks:
            sub += struct.pack("<II", bit_off, out_off)
    extra = b"ZZ" + struct.pack("<H", len(sub)) + bytes(sub)
    hdr = (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
           + struct.pack("<H", len(extra)) + extra)
    blob = hdr + out[header_len:]
    p2 = containers.parse_gzip_index(blob)
    assert p2 is not None and p2[2] == 0  # anchor_tokens == 0 -> per-bit
    assert inflate_tpu.decompress_indexed(blob) == data


def test_walk_defer_paths_identical(monkeypatch):
    """The deferred-scatter walk (record rows in the loop, scatter once)
    and the per-step-scatter walk must produce identical bytes: the same
    (target, value) update set applied via `.max`, order-free."""
    data = (b"defer scatter equivalence corpus 0123456789 " * 1500)[:60000]
    out = zf.compress(
        data, level=6, format="gzip", chunk_bytes=CHUNK, indexed=True
    )
    monkeypatch.setattr(inflate_tpu, "_WALK_DEFER", True)
    a = inflate_tpu.decompress_indexed(out)
    monkeypatch.setattr(inflate_tpu, "_WALK_DEFER", False)
    b = inflate_tpu.decompress_indexed(out)
    assert a == b == data


def test_walk_grouped_vmap_identical(monkeypatch):
    """Stacked all-groups walk dispatch (_walk_all_grouped) vs the
    sequential per-group path: identical bytes, working CRC verify, and
    exact 32 KiB prefix carry across group seams (out cap == window, so
    matches reach fully into the previous group)."""
    monkeypatch.setattr(inflate_tpu, "_WGROUP_OUT", 1 << 15)
    rng = np.random.default_rng(9)
    lump = rng.integers(0, 64, size=3000, dtype=np.uint8).tobytes()
    data = (
        (b"grouped walk seam stress 0123456789 " * 900)[:24000]
        + lump * 8
        + b"\x00" * 40000
        + (lump[:640] * 120)
    )
    out = zf.compress(
        data, level=6, format="gzip", chunk_bytes=16384, indexed=True
    )
    monkeypatch.setattr(inflate_tpu, "_WALK_VMAP", False)
    ref = inflate_tpu.decompress_indexed(out)
    monkeypatch.setattr(inflate_tpu, "_WALK_VMAP", True)
    got = inflate_tpu.decompress_indexed(out)
    assert ref == got == data
    arr, n = inflate_tpu.decompress_indexed(out, to_device=True)
    assert n == len(data) and bytes(np.asarray(arr)) == data
    # CRC still guards the stacked path: flip a payload byte.
    bad = bytearray(out)
    bad[len(bad) // 2] ^= 0x40
    with pytest.raises(ValueError):
        inflate_tpu.decompress_indexed(bytes(bad))
