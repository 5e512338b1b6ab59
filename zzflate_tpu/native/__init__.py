"""ctypes binding for the native runtime (inflate + checksums).

The shared library is built lazily from the bundled C source the first time
it is needed (gcc is part of the image; pybind11 is not, hence ctypes).
Everything degrades gracefully: `lib()` returns None if no compiler is
available and callers fall back to the pure-Python paths.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "zzflate_native.c")
_SO = os.path.join(_HERE, "_libzzflate.so")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False

# zzt_inflate error codes (keep in sync with zzflate_native.c)
OK = 0
ERRORS = {
    -1: "invalid BTYPE",
    -2: "stored block LEN/NLEN mismatch",
    -3: "invalid Huffman table",
    -4: "invalid symbol",
    -5: "distance too far back",
    -6: "output buffer full",
    -7: "input overrun",
    -8: "need more input",
}
E_AGAIN = -8


def _build() -> bool:
    for cc in ("gcc", "cc", "clang"):
        try:
            r = subprocess.run(
                [cc, "-O3", "-shared", "-fPIC", "-o", _SO, _SRC],
                capture_output=True,
                timeout=120,
            )
            if r.returncode == 0:
                return True
        except (OSError, subprocess.TimeoutExpired):
            continue
    return False


def lib() -> ctypes.CDLL | None:
    """The loaded native library, building it on first use; None if
    unavailable (callers must fall back to Python)."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(
            _SRC
        ):
            if not _build():
                return None
        try:
            L = ctypes.CDLL(_SO)
        except OSError:
            return None
        L.zzt_inflate.restype = ctypes.c_int
        L.zzt_inflate.argtypes = [
            ctypes.c_char_p,          # in
            ctypes.c_size_t,          # in_len
            ctypes.c_size_t,          # start_bit
            ctypes.c_void_p,          # out
            ctypes.c_size_t,          # out_cap
            ctypes.c_size_t,          # dict_len
            ctypes.POINTER(ctypes.c_size_t),  # out_len
            ctypes.POINTER(ctypes.c_size_t),  # end_bit
            ctypes.c_size_t,          # stop_bytes
        ]
        L.zzt_inflate_stream.restype = ctypes.c_int
        L.zzt_inflate_stream.argtypes = [
            ctypes.c_char_p,          # in
            ctypes.c_size_t,          # in_len
            ctypes.c_size_t,          # start_bit
            ctypes.c_void_p,          # out
            ctypes.c_size_t,          # out_cap
            ctypes.c_size_t,          # dict_len
            ctypes.POINTER(ctypes.c_size_t),  # out_len
            ctypes.POINTER(ctypes.c_size_t),  # end_bit
            ctypes.c_size_t,          # stop_bytes
            ctypes.POINTER(ctypes.c_uint32),  # bfinal_out
        ]
        L.zzt_scan_anchors.restype = ctypes.c_int
        L.zzt_scan_anchors.argtypes = [
            ctypes.c_char_p,          # in
            ctypes.c_size_t,          # in_len
            ctypes.c_size_t,          # start_bit
            ctypes.c_uint32,          # T (anchor spacing in tokens)
            ctypes.c_size_t,          # dict_len
            ctypes.c_void_p,          # blocks (int64 * 5*blocks_cap)
            ctypes.c_size_t,          # blocks_cap
            ctypes.c_void_p,          # anchors (int64 * 2*anchors_cap)
            ctypes.c_size_t,          # anchors_cap
            ctypes.POINTER(ctypes.c_size_t),  # nblocks
            ctypes.POINTER(ctypes.c_size_t),  # nanchors
            ctypes.POINTER(ctypes.c_size_t),  # total_out
            ctypes.POINTER(ctypes.c_size_t),  # end_bit
        ]
        L.zzt_adler32.restype = ctypes.c_uint32
        L.zzt_adler32.argtypes = [
            ctypes.c_uint32, ctypes.c_char_p, ctypes.c_size_t
        ]
        L.zzt_crc32.restype = ctypes.c_uint32
        L.zzt_crc32.argtypes = [
            ctypes.c_uint32, ctypes.c_char_p, ctypes.c_size_t
        ]
        L.zzt_optimal_parse.restype = ctypes.c_int
        L.zzt_optimal_parse.argtypes = [
            ctypes.c_void_p,          # data (uint8*)
            ctypes.c_void_p,          # mlen (int32*)
            ctypes.c_void_p,          # mdist (int32*)
            ctypes.c_int64,           # n
            ctypes.c_int64,           # start
            ctypes.c_int64,           # end
            ctypes.c_void_p,          # ll_bits (nsb x 288 int32)
            ctypes.c_void_p,          # d_bits  (nsb x 30 int32)
            ctypes.c_void_p,          # sub_bounds (int64*)
            ctypes.c_int,             # nsb
            ctypes.c_void_p,          # committed out (uint8*)
            ctypes.c_void_p,          # take out (uint8*)
            ctypes.c_void_p,          # sel_len out (int32*)
        ]
        L.zzt_deflate.restype = ctypes.c_int
        L.zzt_deflate.argtypes = [
            ctypes.c_char_p,          # in
            ctypes.c_size_t,          # n
            ctypes.c_int,             # level
            ctypes.c_int,             # strategy (zlib.h:196-200 values)
            ctypes.c_char_p,          # dict
            ctypes.c_size_t,          # dict_len
            ctypes.c_int32,           # max_dist
            ctypes.c_int,             # final
            ctypes.c_void_p,          # out
            ctypes.c_size_t,          # out_cap
            ctypes.POINTER(ctypes.c_size_t),  # out_len
        ]
        _lib = L
        return _lib


def inflate_raw(
    data: bytes,
    dictionary: bytes = b"",
    bitpos: int = 0,
    out_cap_hint: int | None = None,
) -> tuple[bytes, int]:
    """Native raw-deflate decode. Returns (output, end_bitpos).

    Raises ValueError on malformed streams (same contract as the Python
    decoder in models/inflate.py). Grows the output buffer geometrically on
    ZZT_E_OUTFULL.
    """
    L = lib()
    if L is None:
        raise RuntimeError("native library unavailable")
    dictionary = dictionary[-32768:]
    dlen = len(dictionary)
    cap = out_cap_hint or max(4 * len(data) + 4096, 1 << 16)
    while True:
        buf = ctypes.create_string_buffer(dlen + cap)
        if dlen:
            ctypes.memmove(buf, dictionary, dlen)
        out_len = ctypes.c_size_t(0)
        end_bit = ctypes.c_size_t(0)
        rc = L.zzt_inflate(
            data,
            len(data),
            bitpos,
            ctypes.byref(buf),
            dlen + cap,
            dlen,
            ctypes.byref(out_len),
            ctypes.byref(end_bit),
            0,
        )
        if rc == OK:
            out = ctypes.string_at(
                ctypes.addressof(buf) + dlen, out_len.value
            )
            return out, end_bit.value
        if rc == -6:  # output full: grow and retry
            cap *= 4
            continue
        raise ValueError(ERRORS.get(rc, f"inflate error {rc}"))


def inflate_stream(
    data: bytes,
    window: bytes = b"",
    bitpos: int = 0,
    stop_bytes: int = 0,
    out_cap_hint: int | None = None,
) -> tuple[bytes, int, bool, bool]:
    """Incremental raw-deflate decode of as many COMPLETE blocks as `data`
    allows, starting at `bitpos` with `window` as back-reference context.

    Returns (output, end_bitpos, bfinal_reached, need_more_input). When
    need_more_input is True, end_bitpos is the last complete block
    boundary; feed more bytes and call again from there. Raises
    ValueError on corruption strictly inside the available input.
    """
    L = lib()
    if L is None:
        raise RuntimeError("native library unavailable")
    window = window[-32768:]
    dlen = len(window)
    cap = out_cap_hint or max(4 * len(data) + 4096, 1 << 16)
    while True:
        buf = ctypes.create_string_buffer(dlen + cap)
        if dlen:
            ctypes.memmove(buf, window, dlen)
        out_len = ctypes.c_size_t(0)
        end_bit = ctypes.c_size_t(0)
        bfinal = ctypes.c_uint32(0)
        rc = L.zzt_inflate_stream(
            data, len(data), bitpos, ctypes.byref(buf), dlen + cap, dlen,
            ctypes.byref(out_len), ctypes.byref(end_bit), stop_bytes,
            ctypes.byref(bfinal),
        )
        if rc == -6:  # output full: grow and retry
            cap *= 4
            continue
        if rc in (OK, E_AGAIN):
            out = ctypes.string_at(
                ctypes.addressof(buf) + dlen, out_len.value
            )
            return out, end_bit.value, bool(bfinal.value), rc == E_AGAIN
        raise ValueError(ERRORS.get(rc, f"inflate error {rc}"))


def scan_anchors(
    data: bytes,
    anchor_tokens: int,
    bitpos: int = 0,
    dict_len: int = 0,
):
    """Anchor pre-scan of a raw deflate stream (no output materialized).

    Returns (blocks, anchors, total_out, end_bit):
      blocks  — int64 (nb, 5): [start_bit, btype, out_start,
                stored_payload_byte_off, stored_len]
      anchors — int64 (na, 2): [bit, out] of every anchor_tokens-th
                token within its block (bit BEFORE the token's code)
    These are exactly the lane records the device anchor-walk decoder
    consumes, so foreign (unindexed) zlib/gzip streams can decode on
    device after this host scan. Raises ValueError on corruption.
    """
    import numpy as _np

    L = lib()
    if L is None:
        raise RuntimeError("native library unavailable")
    n = len(data)
    # Generous first guesses; the scan reports required counts on
    # overflow, so at most one retry.
    bcap = max(64, n // 8192)
    acap = max(64, (8 * n) // max(1, anchor_tokens))
    while True:
        blocks = _np.zeros((bcap, 5), _np.int64)
        anchors = _np.zeros((acap, 2), _np.int64)
        nb = ctypes.c_size_t(0)
        na = ctypes.c_size_t(0)
        total_out = ctypes.c_size_t(0)
        end_bit = ctypes.c_size_t(0)
        rc = L.zzt_scan_anchors(
            data, n, bitpos, anchor_tokens, dict_len,
            blocks.ctypes.data_as(ctypes.c_void_p), bcap,
            anchors.ctypes.data_as(ctypes.c_void_p), acap,
            ctypes.byref(nb), ctypes.byref(na),
            ctypes.byref(total_out), ctypes.byref(end_bit),
        )
        if rc == -6:  # a cap was too small; counts hold required sizes
            bcap = max(bcap, nb.value + 1)
            acap = max(acap, na.value + 1)
            continue
        if rc == OK:
            return (
                blocks[: nb.value],
                anchors[: na.value],
                total_out.value,
                end_bit.value,
            )
        raise ValueError(ERRORS.get(rc, f"inflate error {rc}"))


def adler32(data: bytes, value: int = 1) -> int:
    L = lib()
    if L is None:
        import zlib

        return zlib.adler32(data, value)
    if not isinstance(data, bytes):
        data = bytes(data)  # c_char_p rejects bytearray/memoryview; stdlib
    return int(L.zzt_adler32(value, data, len(data)))  # zlib accepts any buffer


def crc32(data: bytes, value: int = 0) -> int:
    L = lib()
    if L is None:
        import zlib

        return zlib.crc32(data, value)
    if not isinstance(data, bytes):
        data = bytes(data)  # see adler32: keep the stdlib buffer contract
    return int(L.zzt_crc32(value, data, len(data)))


def optimal_parse(data, mlen, mdist, start, end, ll_bits, d_bits, bounds):
    """Shortest-bit-path parse of one chunk (level-9 encoder, C DP).

    data/mlen/mdist: (N,) numpy uint8/int32/int32; ll_bits (SB, 288) and
    d_bits (SB, 30) int32 provisional code lengths; bounds: SB+1 token
    boundaries. Returns (committed, take, sel_len) numpy arrays, or None
    when the native library is unavailable (caller falls back to the
    device lazy parse).
    """
    import numpy as np

    L = lib()
    if L is None:
        return None
    n = len(data)
    data = np.ascontiguousarray(data, np.uint8)
    mlen = np.ascontiguousarray(mlen, np.int32)
    mdist = np.ascontiguousarray(mdist, np.int32)
    ll_bits = np.ascontiguousarray(ll_bits, np.int32)
    d_bits = np.ascontiguousarray(d_bits, np.int32)
    sub_bounds = np.ascontiguousarray(bounds, np.int64)
    committed = np.zeros(n, np.uint8)
    take = np.zeros(n, np.uint8)
    sel_len = np.zeros(n, np.int32)
    rc = L.zzt_optimal_parse(
        data.ctypes.data, mlen.ctypes.data, mdist.ctypes.data,
        n, int(start), int(end),
        ll_bits.ctypes.data, d_bits.ctypes.data, sub_bounds.ctypes.data,
        int(ll_bits.shape[0]),
        committed.ctypes.data, take.ctypes.data, sel_len.ctypes.data,
    )
    if rc != 0:
        raise RuntimeError(f"zzt_optimal_parse failed: {rc}")
    return committed.astype(bool), take.astype(bool), sel_len


def deflate_raw(
    data: bytes,
    level: int = 6,
    dictionary: bytes = b"",
    max_dist: int = 32768,
    final: bool = True,
    strategy: int = 0,
) -> bytes:
    """Native one-shot raw-deflate encode (zzt_deflate).

    The host-side engine companion to the device pipeline: hash-chain
    matcher with the classic good/lazy/nice/chain effort table, exact
    per-64 KiB stored/fixed/dynamic choice (SURVEY.md C5-C14). Returns
    raw DEFLATE bits; callers add containers. final=False closes with a
    sync-flush empty stored block (byte-aligned, Z_SYNC_FLUSH framing)
    so segments concatenate into one valid stream. Raises RuntimeError
    when the native library is unavailable.
    """
    L = lib()
    if L is None:
        raise RuntimeError("native library unavailable")
    dictionary = dictionary[-32768:]
    n = len(data)
    # Stored-fallback bound + per-64KiB block headers + slack.
    cap = n + 5 * (n // 65535 + 2) + (n // 65536 + 2) * 320 + 1024
    buf = ctypes.create_string_buffer(cap)
    out_len = ctypes.c_size_t(0)
    rc = L.zzt_deflate(
        data, n, int(level), int(strategy), dictionary, len(dictionary),
        int(max_dist), 1 if final else 0,
        ctypes.byref(buf), cap, ctypes.byref(out_len),
    )
    if rc != 0:
        raise RuntimeError(f"zzt_deflate failed: {rc}")
    return ctypes.string_at(ctypes.addressof(buf), out_len.value)


def deflate_raw_mt(
    data: bytes,
    level: int = 6,
    dictionary: bytes = b"",
    max_dist: int = 32768,
    final: bool = True,
    strategy: int = 0,
    chunk_bytes: int = 1 << 20,
    threads: int | None = None,
) -> bytes:
    """Chunk-parallel native encode (the host-engine analogue of the
    device pipeline's DP axis, SURVEY.md section 2.1): window-aligned
    chunks, each seeded with the previous 32 KiB as its dictionary halo,
    encoded on a thread pool (zzt_deflate releases the GIL) and joined
    with sync-flush framing into ONE valid deflate stream — the same
    stitching contract the multi-chip gather uses. Ratio cost is the
    usual ~0.3%/MiB-chunk halo truncation.

    The chunk layout (and therefore the output bytes) depends ONLY on
    (data, parameters): inputs above chunk_bytes are chunked even with
    one worker, so the same call produces identical bytes on any
    machine — `threads` affects wall-clock only."""
    import concurrent.futures as _cf
    import os as _os

    n = len(data)
    nth = threads or min(8, _os.cpu_count() or 1)
    if n <= chunk_bytes:
        return deflate_raw(
            data, level=level, dictionary=dictionary, max_dist=max_dist,
            final=final, strategy=strategy,
        )
    nchunks = -(-n // chunk_bytes)

    def one(i: int) -> bytes:
        lo = i * chunk_bytes
        hi = min(n, lo + chunk_bytes)
        dic = dictionary if i == 0 else data[max(0, lo - 32768) : lo]
        return deflate_raw(
            data[lo:hi], level=level, dictionary=dic, max_dist=max_dist,
            final=final and i == nchunks - 1, strategy=strategy,
        )

    with _cf.ThreadPoolExecutor(max_workers=nth) as pool:
        return b"".join(pool.map(one, range(nchunks)))
