"""Device-parallel inflate for indexed gzip streams (SURVEY.md C17/M4).

DEFLATE decode is bit-serial: each symbol's width is unknown until the
previous symbol is decoded. Two data-parallel answers live here (cf. the
parallel-decompression literature referenced in PAPERS.md, patterns
only), selected by the stream's 'ZZ' FEXTRA index version:

**Anchor-walk decode (v3 streams — the fast path).** The encoder
records the (bit, output) position of every ANCHOR_TOKENS-th committed
token (utils/containers.py). Decode launches one LANE per recorded
position (block starts + anchors): each lane walks its token interval
serially — 3 word gathers + 2 LUT gathers per step, all lanes in
parallel — scattering (literal | match start/dist) at exact output
offsets. No speculation, no commit resolution: the index already says
where tokens start. Lanes deactivate at EOB and may deterministically
re-walk the next interval's head (identical scatters, harmless).

**Speculative per-bit decode (v2 streams / no anchors — legacy path).**
A candidate token is decoded at EVERY bit (2 LUT gathers/bit over
windows built with shift algebra), then hierarchical serial row sweeps
(~1000 tiny steps) find the true token boundaries from each block's
indexed start bit.

Shared machinery:

- **Device-built LUTs** from ~700-byte canonical descriptors — the host
  never materialises 2^15-entry tables.
- **Parallel LZ resolution.** Tokens scatter (start, dist) spans into
  output space; segmented cummax finds each byte's covering token; the
  closed-form in-token hop (s - d + ((i-s) mod d)) collapses overlap
  chains, and pointer doubling with a convergence test finishes the
  (shallow) nested-token chains.
- **Fixed-shape groups.** Streams of any size decode in groups of
  consecutive chunks sharing ONE compiled graph, carrying the previous
  32 KiB of output as a resolved prefix across seams (bounded graph and
  buffer sizes for any stream length).
- **Device-resident output.** Bytes stay on device; CRC-32 runs there
  (fused into the walk dispatch) and only 4 bytes return to verify.
  `to_device=True` returns the device array — the data-loading path.
  Byte fetches to the host happen in bounded slices.

Streams without a 'ZZ' index fall back to the native C decoder
(zzflate_tpu/native). Only streams produced by this package are indexed,
so the one-block-per-index-entry layout is guaranteed.
"""
from __future__ import annotations

import functools
import os
import struct
import zlib as _zlib

import numpy as np

import jax
import jax.numpy as jnp

from zzflate_tpu import constants as C
from zzflate_tpu.models.inflate import BitReader, _read_dynamic_tables
from zzflate_tpu.utils import containers

_LUT_BITS = 15
_R = 256                      # row size in bits for the commit sweeps
_RR = _R * _R                 # superrow size
_HUGE = _R + 1                # step value meaning "EOB / invalid: stop"

_W = 32768                    # DEFLATE window: max LZ reach across groups
# Streams larger than one device graph decode in GROUPS of consecutive
# chunks: every group reuses ONE compiled shape, and carries
# the previous 32 KiB of output as a resolved prefix so LZ references
# across the group seam stay exact. _GROUP_OUT bounds the group's OUTPUT
# so high-ratio data cannot blow up the padded output buffer.
_GROUP_BITS = 1 << 22
_GROUP_BODY = (_GROUP_BITS - 16) // 8
_GROUP_OUT = 2 << 20

_MAX_LL = 288
_MAX_D = 32  # HDIST is 5 bits: up to 32 dist codes (30/31 invalid if used)

# XLA unroll factor for the anchor-walk token loop: each iteration's real
# work is lane-width (~1-4K elements), so if per-iteration loop overhead
# dominates, unrolling wins. Env-tunable for A/B runs.
_WALK_UNROLL = int(os.environ.get("ZZFLATE_WALK_UNROLL", "1"))

# Deferred-scatter walk (default): the token loop records each step's
# (target, literal, dist) as a ROW of (t_steps, lanes) arrays — a
# contiguous dynamic_update_slice, cheap — and the three output-space
# scatters run ONCE over all t_steps*lanes records after the loop,
# instead of 3 full-width scatters inside every loop step. Identical
# results (`.max` over the same update set is order-free); env opt-out
# for A/B runs.
_WALK_DEFER = os.environ.get("ZZFLATE_WALK_DEFER", "1") != "0"

# Stacked multi-group walk decode (_walk_all_grouped): all groups' walks
# and LZ chases run in ONE vmapped dispatch, with the 32 KiB group-seam
# prefix chained through a G-step scan of the final byte-gather. Default
# off until the compile cost of the G-wide graph (arrays of
# G x n_out_pad elements) is measured; correctness is equivalence-tested
# on CPU either way.
_WALK_VMAP = os.environ.get("ZZFLATE_WALK_VMAP", "0") == "1"
# LUT-free walk decode (round 5): canonical boundary-sum code lengths
# from per-lane tables + closed-form attributes instead of materialized
# (U, 2^15) LUTs — drops the LUT builds' ~4 full-width gathers per group
# at the cost of ~60 extra fused elementwise ops per walk step.
# ZZFLATE_WALK_NOLUT=0 restores the LUT path (A/B).
_WALK_NOLUT = os.environ.get("ZZFLATE_WALK_NOLUT", "1") != "0"

# Walk-path group caps (compressed body / decoded output per device
# graph). Module-level so tests can shrink them to force multi-group
# streams on small CPU fixtures.
_WGROUP_BODY = 4 << 20
_WGROUP_OUT = (4 << 20) - _W


# ---------------------------------------------------------------------------
# Module constants (device-cached on first use).
# ---------------------------------------------------------------------------


@functools.cache
def _brev15() -> np.ndarray:
    """brev15[w] = 15-bit reversal of w: the MSB-first code value whose
    LSB-first stream bits are w's low bits (any code length: the first
    ln bits of the reversal depend only on w's low ln bits)."""
    w = np.arange(1 << _LUT_BITS, dtype=np.uint32)
    r = np.zeros_like(w)
    for i in range(_LUT_BITS):
        r |= ((w >> i) & 1) << (_LUT_BITS - 1 - i)
    return r.astype(np.int32)


@functools.cache
def _ll_attr() -> np.ndarray:
    """Per-litlen-symbol attributes: lext(3b) | lbase<<3 (9b) |
    eob<<12 | islen<<13 | bad<<14 (RFC 1951 3.2.5)."""
    a = np.zeros(_MAX_LL, np.int32)
    a[256] = 1 << 12
    for s in range(257, 286):
        a[s] = (
            int(C.LENGTH_EXTRA[s - 257])
            | (int(C.LENGTH_BASE[s - 257]) << 3)
            | (1 << 13)
        )
    a[286] = a[287] = 1 << 14  # reserved symbols: corrupt if used
    return a


@functools.cache
def _d_attr() -> np.ndarray:
    """Per-distance-symbol attributes: dext(4b) | dbase<<4 (15b).
    Symbols 30/31 keep attr 0 (dbase 0 marks them corrupt if decoded)."""
    a = np.zeros(_MAX_D, np.int32)
    for s in range(30):
        a[s] = int(C.DIST_EXTRA[s]) | (int(C.DIST_BASE[s]) << 4)
    return a


# ---------------------------------------------------------------------------
# Host: per-block canonical descriptors (tiny; LUTs are built on device).
# ---------------------------------------------------------------------------


def _canon_desc(dec, nsym: int):
    """(first16, cnt16, off16, symtab) int32 arrays from a CanonicalDecoder."""
    first = np.zeros(16, np.int32)
    cnt = np.zeros(16, np.int32)
    off = np.zeros(16, np.int32)
    for ln in range(1, min(dec.max_len, 15) + 1):
        cnt[ln] = dec.counts[ln]
        first[ln] = dec.first_code[ln]
        off[ln] = dec.offsets[ln]
    symtab = np.zeros(nsym, np.int32)
    symtab[: len(dec.syms)] = dec.syms
    return first, cnt, off, symtab


class _FixedDecs:
    """Cached CanonicalDecoder pair for BTYPE=1 blocks."""

    _pair = None

    @classmethod
    def get(cls):
        if cls._pair is None:
            from zzflate_tpu.models.inflate import CanonicalDecoder

            cls._pair = (
                CanonicalDecoder(list(C.fixed_litlen_lengths())),
                CanonicalDecoder(list(C.fixed_dist_lengths())),
            )
        return cls._pair


class _Unit:
    __slots__ = ("bit", "out_base", "ll", "d")

    def __init__(self, bit, out_base, ll, d):
        self.bit = bit          # absolute bit offset into the body
        self.out_base = out_base
        self.ll = ll            # (first, cnt, off, symtab) litlen
        self.d = d              # (first, cnt, off, symtab) dist


def _plan_units(body: bytes, chunks, out_starts, out_sizes):
    """Host walk: per indexed block, parse its header into canonical
    descriptors; stored segments become RUN DESCRIPTORS
    (out_pos, body_byte_off, len) — their payload bytes already live in
    the uploaded words buffer, so only ~12 B/run crosses the host->device
    link instead of 9 B per stored BYTE.
    Offsets (bit and output) are relative to the given body/out space.
    unit_ranges[i] is the [lo, hi) slice of `units` from chunk i
    (empty for stored-fallback chunks)."""
    units = []
    stored_runs: list[tuple[int, int, int]] = []
    unit_ranges: list[tuple[int, int]] = []
    pos = 0
    for i, (sz, blocks, _anchors) in enumerate(chunks):
        seg = body[pos : pos + sz]
        seg_bit0 = pos * 8
        seg_byte0 = pos
        pos += sz
        ulo = len(units)
        br = BitReader(seg, 0)
        br.bits(1)
        if br.bits(2) == 0:
            stored_runs.extend(
                _stored_runs(seg, out_starts[i], out_sizes[i], seg_byte0)
            )
            unit_ranges.append((ulo, ulo))
            continue
        for bit_off, out_off in blocks:
            b = BitReader(seg, bit_off)
            b.bits(1)
            btype = b.bits(2)
            if btype == 1:
                lld, dd = _FixedDecs.get()
            elif btype == 2:
                lld, dd = _read_dynamic_tables(b)
            else:
                raise ValueError("corrupt indexed segment: bad BTYPE")
            units.append(
                _Unit(
                    seg_bit0 + b.bitpos,
                    out_starts[i] + out_off,
                    _canon_desc(lld, _MAX_LL),
                    _canon_desc(dd, _MAX_D),
                )
            )
        unit_ranges.append((ulo, len(units)))
    return units, stored_runs, unit_ranges


def _stored_runs(seg: bytes, out_base: int, out_bytes: int,
                 seg_byte0: int) -> list[tuple[int, int, int]]:
    """Walk the byte-aligned stored blocks of a fallback segment (host),
    yielding (out_pos, body_byte_off, len) run descriptors."""
    br = BitReader(seg, 0)
    runs: list[tuple[int, int, int]] = []
    done = 0
    while done < out_bytes:
        br.bits(3)
        br.align()
        p = br.bitpos >> 3
        (ln,) = struct.unpack("<H", seg[p : p + 2])
        if ln:
            runs.append((out_base + done, seg_byte0 + p + 4, ln))
        done += ln
        br.bitpos = (p + 4 + ln) << 3
    return runs


# ---------------------------------------------------------------------------
# Device: LUT build + per-bit decode + hierarchical commit + LZ resolve.
# ---------------------------------------------------------------------------


def _build_luts(first, cnt, off, symtab, attr, nsym, sym_bits):
    """(U,16)x3 + (U,nsym) descriptors -> (U, 2^15) packed LUT.

    Entry: sym(sym_bits) | nb<<sym_bits (4b) | attr<<(sym_bits+4);
    0 = invalid window. sym_bits=10 (litlen, 15-bit attr) or 5
    (distance, whose 19-bit attr would overflow u32 with a 10-bit
    symbol field).

    Canonical closed form (replacing a 15-round masked range cascade):
    canonical assignment makes the
    left-aligned code ranges TILE the window space contiguously —
    first_aligned[ln+1] == hi_aligned[ln], where
    hi_aligned[ln] = (first[ln]+cnt[ln]) << (15-ln) — so a window's
    code length is ln(v) = 1 + #{L : v >= hi_aligned[L]}, a sum of 15
    compares, and its symbol index is
    off[ln] + ((v - first[ln]<<(15-ln)) >> (15-ln)). Zero-width
    lengths collapse (equal boundaries) and incomplete trees leave
    v >= hi_aligned[15] -> invalid."""
    c = jnp.asarray(_brev15())[None, :]  # (1, 32768) reversed windows
    ln_r = jnp.arange(16, dtype=jnp.int32)
    hi_aligned = (first + cnt) << (15 - ln_r)  # (U, 16)
    # Descriptors zero first/cnt beyond the tree's max length, which
    # would fold those boundaries back to 0; the running max keeps the
    # boundary sequence monotone (trailing lengths inherit the last
    # real boundary, leading empty lengths stay at 0 and count v >= 0
    # exactly once each — the tiling offset).
    hi_mono = jax.lax.cummax(hi_aligned, axis=1)
    ln_sel = jnp.int32(1) + sum(
        (c >= hi_mono[:, L][:, None]).astype(jnp.int32)
        for L in range(1, 16)
    )
    valid = ln_sel <= 15
    lnc = jnp.clip(ln_sel, 1, 15)
    idx_sel = jnp.zeros(c.shape[:1] + (1 << _LUT_BITS,), jnp.int32)
    for L in range(1, 16):
        rel = (c - (first[:, L] << (15 - L))[:, None]) >> (15 - L)
        idx_sel = jnp.where(
            lnc == L, off[:, L][:, None] + rel, idx_sel
        )
    # Zero-width lengths never win (their aligned range is empty: the
    # boundary sum walks past them), so cnt[lnc] > 0 wherever valid.
    sym = jnp.take_along_axis(
        symtab, jnp.clip(idx_sel, 0, nsym - 1), axis=1
    )
    a = attr[sym]
    ent = sym | (lnc << sym_bits) | (a << (sym_bits + 4))
    return jnp.where(valid, ent, 0)


def _bit_windows(words: jax.Array):
    """48+-bit windows for every bit position, zero gathers: for bit
    p = 32w + s, win_lo = bits p..p+31, win_hi = bits p+32..p+63."""
    s = jnp.arange(32, dtype=jnp.uint32)[None, :]
    w0 = words[:-2, None]
    w1 = words[1:-1, None]
    w2 = words[2:, None]
    inv = jnp.uint32(31) - s
    lo = (w0 >> s) | ((w1 << inv) << jnp.uint32(1))
    hi = (w1 >> s) | ((w2 << inv) << jnp.uint32(1))
    return lo.reshape(-1), hi.reshape(-1)


def _extract(lo, hi, offset, n):
    """n (<=15) bits at bit `offset` (<=35) of the 64-bit window (lo, hi)."""
    o = jnp.minimum(offset, 31).astype(jnp.uint32)
    a = (lo >> o) | ((hi << (jnp.uint32(31) - o)) << jnp.uint32(1))
    b = hi >> jnp.clip(offset - 32, 0, 31).astype(jnp.uint32)
    r = jnp.where(offset < 32, a, b)
    mask = (jnp.uint32(1) << n.astype(jnp.uint32)) - jnp.uint32(1)
    return (r & mask).astype(jnp.int32)


def _decode_bits(win_lo, win_hi, uid, ll_lut, d_lut):
    """Candidate token at every bit: (step, outlen, lit, mdist, kind)."""
    lut_mask = jnp.uint32((1 << _LUT_BITS) - 1)
    flat_ll = ll_lut.reshape(-1)
    flat_d = d_lut.reshape(-1)
    base = uid << _LUT_BITS

    e = flat_ll[base + (win_lo & lut_mask).astype(jnp.int32)]
    sym = e & 0x3FF
    nb = (e >> 10) & 15
    a = e >> 14
    lext = a & 7
    lbase = (a >> 3) & 511
    valid = (nb > 0) & ((a & (1 << 14)) == 0)
    iseob = (a & (1 << 12)) != 0
    islen = (a & (1 << 13)) != 0
    mlen = lbase + _extract(win_lo, win_hi, nb, lext)

    off2 = nb + lext
    w2 = _extract(win_lo, win_hi, off2, jnp.int32(_LUT_BITS))
    de = flat_d[base + w2]
    dnb = (de >> 5) & 15
    da = de >> 9
    dext = da & 15
    dbase = (da >> 4) & 32767
    dvalid = (dnb > 0) & (dbase > 0)  # dbase 0 = reserved symbol 30/31
    mdist = dbase + _extract(win_lo, win_hi, off2 + dnb, dext)

    invalid = ~valid | (islen & ~dvalid)
    width = jnp.where(islen, off2 + dnb + dext, nb)
    step = jnp.where(invalid | iseob, _HUGE, width)
    islit = valid & ~iseob & ~islen
    outlen = jnp.where(islit, 1, jnp.where(islen & ~invalid, mlen, 0))
    return step, outlen, sym, mdist, islit, islen & ~invalid, iseob & valid


def _brev15_dyn(x):
    """15-bit reversal of x's low 15 bits, elementwise (the in-kernel
    form of the _brev15() table: reverse 16 bits, then drop the top)."""
    x = x.astype(jnp.uint32) & jnp.uint32(0x7FFF)
    x = ((x & jnp.uint32(0x5555)) << 1) | ((x >> 1) & jnp.uint32(0x5555))
    x = ((x & jnp.uint32(0x3333)) << 2) | ((x >> 2) & jnp.uint32(0x3333))
    x = ((x & jnp.uint32(0x0F0F)) << 4) | ((x >> 4) & jnp.uint32(0x0F0F))
    x = ((x & jnp.uint32(0x00FF)) << 8) | ((x >> 8) & jnp.uint32(0x00FF))
    return (x >> 1).astype(jnp.int32)


def _canon_lane_tables(first, cnt, off, uid):
    """Per-lane canonical decode tables, gathered ONCE per walk: the
    monotone left-aligned range boundaries (hi), left-aligned first
    codes (fsh) and symbol offsets per code length — all (lanes, 16).
    Same closed form as _build_luts, without materializing (U, 2^15)
    tables (whose ~2M-element symbol+attr gathers per group would
    otherwise run before every walk)."""
    ln_r = jnp.arange(16, dtype=jnp.int32)[None, :]
    hi = (first + cnt) << (15 - ln_r)
    hi_mono = jax.lax.cummax(hi, axis=1)
    fsh = first << (15 - ln_r)
    return hi_mono[uid], fsh[uid], off[uid]


def _canon_symbol(v15, hi_lane, fsh_lane, off_lane, sym_flat, uid, nsym):
    """Decode one canonical symbol per lane from the left-aligned window
    value v15: code length by boundary sum (15 compares), symbol index
    by offset arithmetic (one-hot selects — no per-step table gathers
    beyond the final symbol lookup)."""
    ln = jnp.int32(1) + sum(
        (v15 >= hi_lane[:, L]).astype(jnp.int32) for L in range(1, 16)
    )
    valid = ln <= 15
    lnc = jnp.clip(ln, 1, 15)
    fsel = jnp.zeros_like(v15)
    osel = jnp.zeros_like(v15)
    for L in range(1, 16):
        m = lnc == L
        fsel = jnp.where(m, fsh_lane[:, L], fsel)
        osel = jnp.where(m, off_lane[:, L], osel)
    idx = osel + ((v15 - fsel) >> (15 - lnc))
    sym = sym_flat[uid * nsym + jnp.clip(idx, 0, nsym - 1)]
    return sym, lnc, valid


def _decode_bits_canon(win_lo, win_hi, uid, llt, dt, ll_sym_flat,
                       d_sym_flat):
    """LUT-free _decode_bits: canonical boundary-sum code lengths from
    per-lane tables + closed-form length/distance attributes. Decode
    semantics are bit-for-bit those of the (U, 2^15) LUT path (same
    validity/EOB/reserved-symbol handling), with two small symbol-table
    gathers per step instead of two LUT gathers — and no LUT build."""
    from zzflate_tpu.models.deflate_encoder import (
        _dist_extra_base, _len_extra_base,
    )

    hi_l, fsh_l, off_l = llt
    v = _brev15_dyn(win_lo)
    sym, nb, lvalid = _canon_symbol(
        v, hi_l, fsh_l, off_l, ll_sym_flat, uid, _MAX_LL
    )
    iseob = sym == 256
    islen0 = (sym >= 257) & (sym <= 285)
    valid = lvalid & (sym <= 285)
    lext, lbase = _len_extra_base(jnp.clip(sym - 257, 0, 28))
    lext = jnp.where(islen0, lext, 0)
    mlen = lbase + _extract(win_lo, win_hi, nb, lext)
    off2 = nb + lext

    hi_d, fsh_d, off_d = dt
    w2 = _extract(win_lo, win_hi, off2, jnp.int32(15))
    vd = _brev15_dyn(w2)
    dsym, dnb, dv = _canon_symbol(
        vd, hi_d, fsh_d, off_d, d_sym_flat, uid, _MAX_D
    )
    dvalid = dv & (dsym < 30)
    dext, dbase = _dist_extra_base(jnp.clip(dsym, 0, 29))
    mdist = dbase + _extract(win_lo, win_hi, off2 + dnb, dext)

    invalid = ~valid | (islen0 & ~dvalid)
    width = jnp.where(islen0, off2 + dnb + dext, nb)
    step = jnp.where(invalid | iseob, _HUGE, width)
    islit = valid & ~iseob & ~islen0
    outlen = jnp.where(islit, 1, jnp.where(islen0 & ~invalid, mlen, 0))
    return step, outlen, sym, mdist, islit, islen0 & ~invalid, iseob & valid


def _commit_walk(step, start_bits, unit_valid, max_sup_span):
    """Exact token-boundary commit via hierarchical serial sweeps.

    step: (nbits,) per-bit token width (_HUGE stops the walk);
    start_bits: (U,) absolute first-token bit per block. Returns the
    (nbits,) bool committed mask. nbits must be a multiple of _R*_R."""
    nbits = step.shape[0]
    nrows = nbits // _R
    nsup = nbits // _RR
    sink = jnp.int32(nbits)

    # P1: exit-of-row for every bit (reverse sweep, _R steps).
    st_t = step.reshape(nrows, _R).T  # (_R, nrows)
    row_base = jnp.arange(nrows, dtype=jnp.int32) * _R

    def p1(t, ex):
        j = _R - 1 - t
        s = jax.lax.dynamic_slice(st_t, (j, 0), (1, nrows))[0]
        land = j + s
        hop = jnp.take_along_axis(
            ex, jnp.clip(land, 0, _R - 1)[None, :], axis=0
        )[0]
        val = jnp.where(
            s > _R, sink, jnp.where(land >= _R, row_base + land, hop)
        )
        val = jnp.minimum(val, sink)
        return jax.lax.dynamic_update_slice(ex, val[None, :], (j, 0))

    ex = jax.lax.fori_loop(
        0, _R, p1, jnp.zeros((_R, nrows), jnp.int32)
    )
    exit1 = ex.T.reshape(-1)  # (nbits,)

    # P2a: exit-of-superrow for every bit (reverse sweep over rows).
    e1s = exit1.reshape(nsup, _R, _R)
    sup_end = (jnp.arange(nsup, dtype=jnp.int32)[:, None] + 1) * _RR

    def p2a(t, e2):
        j = _R - 1 - t
        x1 = jax.lax.dynamic_slice(e1s, (0, j, 0), (nsup, 1, _R))[:, 0, :]
        hop = e2.reshape(-1)[jnp.clip(x1, 0, nbits - 1)]
        val = jnp.where(x1 >= sup_end, x1, hop)
        return jax.lax.dynamic_update_slice(e2, val[:, None, :], (0, j, 0))

    e2 = jax.lax.fori_loop(
        0, _R, p2a, jnp.zeros((nsup, _R, _R), jnp.int32)
    )
    exit2 = e2.reshape(-1)

    # P2b: per-block superrow chain (few steps, U lanes).
    e0 = jnp.where(unit_valid, start_bits, sink)
    u = e0.shape[0]

    def p2b(k, state):
        ents, e = state
        ents = jax.lax.dynamic_update_slice(ents, e[None, :], (k, 0))
        nxt = exit2[jnp.clip(e, 0, nbits - 1)]
        e = jnp.where(e >= sink, sink, nxt)
        return ents, e

    sup_ents, _ = jax.lax.fori_loop(
        0, max_sup_span, p2b,
        (jnp.full((max_sup_span, u), sink, jnp.int32), e0),
    )

    # P2c: expand superrow entries to row entries (walk exit1 in-sup).
    pos0 = sup_ents.reshape(-1)
    row_entry = jnp.full((nrows,), sink, jnp.int32)

    def p2c(t, state):
        rent, pos = state
        r = jnp.where(pos < sink, pos // _R, nrows)
        rent = rent.at[r].min(pos, mode="drop")
        nxt = exit1[jnp.clip(pos, 0, nbits - 1)]
        same_sup = (nxt // _RR) == (pos // _RR)
        pos = jnp.where((pos < sink) & same_sup, nxt, sink)
        return rent, pos

    row_entry, _ = jax.lax.fori_loop(0, _R, p2c, (row_entry, pos0))

    # P3: mark committed token starts (every entered row, _R steps).
    mark = jnp.zeros((nbits + 1,), jnp.int8)

    def p3(t, state):
        mk, pos = state
        active = pos < sink
        mk = mk.at[jnp.clip(pos, 0, nbits)].max(
            jnp.where(active, 1, 0).astype(jnp.int8), mode="drop"
        )
        s = step[jnp.clip(pos, 0, nbits - 1)]
        nxt = pos + s
        row_end = (jnp.clip(pos, 0, nbits - 1) // _R + 1) * _R
        pos = jnp.where(active & (nxt < row_end), nxt, sink)
        return mk, pos

    mark, _ = jax.lax.fori_loop(0, _R, p3, (mark, row_entry))
    return mark[:nbits] == 1


@functools.partial(
    jax.jit,
    static_argnames=("nbits", "n_out_pad", "max_sup_span", "n_stored"),
)
def _decode_all(
    words, ll_first, ll_cnt, ll_off, ll_sym, d_first, d_cnt, d_off, d_sym,
    start_bits, out_bases, unit_valid, prefix, stored_runs,
    nbits, n_out_pad, max_sup_span, n_stored,
):
    """One fused device graph: LUT build -> per-bit decode -> commit ->
    token scatter -> LZ resolve -> bytes (CRC-32 runs as a separate
    dispatch; see decompress_indexed).

    `prefix` is the previous 32 KiB of decoded output (zeros for the
    first group); it occupies output positions [0, _W) as self-resolved
    literals, so token offsets/bases are shifted by _W and LZ distances
    reaching before this group's first byte land on real history."""
    ll_lut = _build_luts(
        ll_first, ll_cnt, ll_off, ll_sym, jnp.asarray(_ll_attr()),
        _MAX_LL, 10,
    )
    d_lut = _build_luts(
        d_first, d_cnt, d_off, d_sym, jnp.asarray(_d_attr()), _MAX_D, 5
    )

    win_lo, win_hi = _bit_windows(words)

    # Per-bit owning block: scatter block ids at their start bits, cummax.
    u = start_bits.shape[0]
    uid0 = jnp.zeros((nbits,), jnp.int32).at[
        jnp.where(unit_valid, start_bits, nbits)
    ].max(jnp.arange(u, dtype=jnp.int32), mode="drop")
    uid = jax.lax.associative_scan(jnp.maximum, uid0)

    step, outlen, sym, mdist, islit, islen, _eob = _decode_bits(
        win_lo, win_hi, uid, ll_lut, d_lut
    )

    committed = _commit_walk(step, start_bits, unit_valid, max_sup_span)

    # Per-block output offsets: global cumsum minus the block's prefix.
    lens = jnp.where(committed, outlen, 0)
    g = jnp.cumsum(lens)
    sb = jnp.clip(start_bits, 0, nbits - 1)
    cum0 = g[sb] - lens[sb]
    off = out_bases[uid] + (g - lens) - cum0[uid]

    com_tok = committed & (islit | islen)
    tgt = jnp.where(com_tok, off, n_out_pad)
    litval, start_mark, dist_at = _stage_out(
        prefix, stored_runs, words, n_out_pad, n_stored
    )
    litval = litval.at[tgt].max(
        jnp.where(islit, sym, 0), mode="drop"
    )
    start_mark = start_mark.at[tgt].max(
        jnp.where(com_tok, off, -1), mode="drop"
    )
    dist_at = dist_at.at[tgt].max(
        jnp.where(islen, mdist, 0), mode="drop"
    )
    return _resolve_lz(litval, start_mark, dist_at, n_out_pad)


def _stage_out(prefix, stored_runs, words, n_out_pad, n_stored):
    """Initial output-space arrays: the 32 KiB resolved prefix occupies
    [0, _W) as self-resolved literals; stored-run bytes are read
    DEVICE-SIDE out of the words buffer (their payload is part of the
    compressed body) via a run-id segment scan — no per-byte staging.

    stored_runs: (n_stored, 3) int32 [out_pos, body_byte_off, len]
    sorted by out_pos; padding rows have out_pos = n_out_pad, len 0.
    """
    litval = jnp.concatenate(
        [prefix.astype(jnp.int32), jnp.zeros((n_out_pad - _W,), jnp.int32)]
    )
    start_mark = jnp.concatenate(
        [
            jnp.arange(_W, dtype=jnp.int32),
            jnp.full((n_out_pad - _W,), -1, jnp.int32),
        ]
    )
    dist_at = jnp.zeros((n_out_pad,), jnp.int32)
    if n_stored:
        run_out = stored_runs[:, 0]
        run_src = stored_runs[:, 1]
        run_len = stored_runs[:, 2]
        rid = jnp.arange(n_stored, dtype=jnp.int32)
        idx = jnp.arange(n_out_pad, dtype=jnp.int32)
        a = jnp.full((n_out_pad,), -1, jnp.int32).at[run_out].max(
            rid, mode="drop", indices_are_sorted=True, unique_indices=True
        )
        seg = jax.lax.associative_scan(jnp.maximum, a)
        sc = jnp.clip(seg, 0, n_stored - 1)
        within = idx - run_out[sc]
        valid = (seg >= 0) & (within < run_len[sc])
        sb = run_src[sc] + within
        nw = words.shape[0]
        byte = (
            words[jnp.clip(sb >> 2, 0, nw - 1)]
            >> (8 * (sb & 3)).astype(jnp.uint32)
        ).astype(jnp.int32) & 0xFF
        litval = jnp.where(valid, byte, litval)
        start_mark = jnp.where(valid, idx, start_mark)
    return litval, start_mark, dist_at


def _resolve_parent(start_mark, dist_at, n_out_pad):
    """LZ source chase: covering token via segmented cummax, then pointer
    doubling with a convergence test. Returns the fully-chased parent
    array (every position's ultimate LITERAL source index) — a function
    of token structure only, independent of the byte VALUES, which is
    what lets multi-group streams chase all groups in parallel and only
    chain the final byte-gather through the 32 KiB group-seam prefix.

    The first hop is the closed-form in-token source: a match starting
    at s with distance d repeats its source with period d, so position
    i's ultimate within-token source is s - d + ((i - s) mod d) — one
    hop that always lands strictly BEFORE the token start. Overlapped
    copies (dist < len, e.g. a 4 MiB zero run whose byte chain is
    i -> i-1 -> ...) therefore collapse to depth 1 instead of needing
    log2(run) full-width gather rounds; remaining chains are nested
    tokens, which real streams keep shallow."""
    idx = jnp.arange(n_out_pad, dtype=jnp.int32)
    seg = jax.lax.associative_scan(jnp.maximum, start_mark)
    dist = dist_at[jnp.clip(seg, 0, n_out_pad - 1)]
    d1 = jnp.maximum(dist, 1)
    src = seg - d1 + (idx - seg) % d1
    parent = jnp.where((dist > 0) & (seg >= 0), src, idx)
    parent = jnp.clip(parent, 0, n_out_pad - 1)

    def cond(state):
        parent, changed, r = state
        return changed & (r < 40)

    def body(state):
        parent, _, r = state
        p2 = parent[parent]
        return p2, jnp.any(p2 != parent), r + 1

    parent, _, _ = jax.lax.while_loop(
        cond, body, (parent, jnp.bool_(True), jnp.int32(0))
    )
    return parent


def _resolve_lz(litval, start_mark, dist_at, n_out_pad):
    parent = _resolve_parent(start_mark, dist_at, n_out_pad)
    return litval[parent].astype(jnp.uint8)


def _walk_core(
    words, ll_first, ll_cnt, ll_off, ll_sym, d_first, d_cnt, d_off, d_sym,
    lane_bit, lane_out, lane_uid, lane_valid, prefix, stored_runs,
    n_out_pad, n_stored, t_steps, defer,
):
    """Anchor-walk decode (v3 indexed streams): every lane decodes up to
    t_steps tokens serially from a known token-aligned bit position (a
    block start or an every-ANCHOR_TOKENS anchor the encoder recorded).

    Each lane-step costs 3 word gathers + 2 LUT gathers + 3 scatters of
    LANE-count elements, versus the per-bit path's 2 LUT gathers per
    body BIT plus ~1000-step commit sweeps — ~8x less gather traffic
    and no sweeps, because the index already says where tokens start.
    Lanes may deterministically re-walk the head of the next interval
    (identical scatters, so overlap is harmless) and deactivate at EOB
    or on invalid windows (corruption then surfaces as a CRC mismatch).
    """
    uid0 = jnp.clip(lane_uid, 0, ll_first.shape[0] - 1)
    if _WALK_NOLUT:
        # LUT-free decode: per-lane canonical tables (tiny one-time
        # gathers) + closed-form attributes; skips the (U, 2^15) LUT
        # builds entirely (~4 full-width gathers per group).
        llt = _canon_lane_tables(ll_first, ll_cnt, ll_off, uid0)
        dt = _canon_lane_tables(d_first, d_cnt, d_off, uid0)
        ll_sym_flat = ll_sym.reshape(-1)
        d_sym_flat = d_sym.reshape(-1)
    else:
        ll_lut = _build_luts(
            ll_first, ll_cnt, ll_off, ll_sym, jnp.asarray(_ll_attr()),
            _MAX_LL, 10,
        )
        d_lut = _build_luts(
            d_first, d_cnt, d_off, d_sym, jnp.asarray(_d_attr()), _MAX_D, 5
        )
    litval, start_mark, dist_at = _stage_out(
        prefix, stored_runs, words, n_out_pad, n_stored
    )
    # Pack the three output-space arrays into ONE (pos-indexed) int32 —
    # pack = dist << 9 | lit << 1 | started — so the walk emits ONE
    # scatter (or one record buffer) instead of three. dist <= 32768
    # (16 bits), lit <= 255; duplicates from deterministic re-walks
    # write identical values, so max-combining stays exact.
    packed0 = jnp.where(
        start_mark >= 0,
        (dist_at << 9) | (litval << 1) | 1,
        0,
    )
    nw = words.shape[0]
    uid = uid0

    def decode_step(p, o, active, c0, c1, c2, wi_prev):
        """One token per active lane: (emit tgt, lit, dist, next p/o/active,
        new word cache). A token is <= 48 bits, so the window's base word
        advances by at most 2 per step — the first window word always
        comes from the carried cache (2 word gathers per step, not 3)."""
        wi = jnp.clip(p >> 5, 0, nw - 3)
        s = (p & 31).astype(jnp.uint32)
        delta = wi - wi_prev
        w0 = jnp.where(delta == 0, c0, jnp.where(delta == 1, c1, c2))
        w1 = words[wi + 1]
        w2 = words[wi + 2]
        inv = jnp.uint32(31) - s
        lo = (w0 >> s) | ((w1 << inv) << jnp.uint32(1))
        hi = (w1 >> s) | ((w2 << inv) << jnp.uint32(1))
        if _WALK_NOLUT:
            stepw, outlen, sym, mdist, islit, islen, _eob = (
                _decode_bits_canon(
                    lo, hi, uid, llt, dt, ll_sym_flat, d_sym_flat
                )
            )
        else:
            stepw, outlen, sym, mdist, islit, islen, _eob = _decode_bits(
                lo, hi, uid, ll_lut, d_lut
            )
        emit = active & (islit | islen)
        tgt = jnp.where(emit, o, n_out_pad)
        lit = jnp.where(islit, sym, 0)
        dst = jnp.where(islen, mdist, 0)
        o = o + jnp.where(emit, outlen, 0)
        ok = stepw <= 48  # EOB/invalid decode as _HUGE: lane is done
        p = p + jnp.where(active & ok, stepw, 0)
        return tgt, lit, dst, p, o, active & ok, (w0, w1, w2, wi)

    p0 = jnp.where(lane_valid, lane_bit, 0)
    o0 = jnp.where(lane_valid, lane_out, n_out_pad)
    wi0 = jnp.clip(p0 >> 5, 0, nw - 3)
    cache0 = (words[wi0], words[wi0 + 1], words[wi0 + 2], wi0)
    lcount = lane_bit.shape[0]

    def pack_of(lit, dst, emit):
        return jnp.where(emit, (dst << 9) | (lit << 1) | 1, 0)

    if defer:
        def step(t, state):
            rec_tgt, rec_pack, p, o, active, cache = state
            tgt, lit, dst, p, o, active, cache = decode_step(
                p, o, active, *cache
            )
            rec_tgt = jax.lax.dynamic_update_slice(
                rec_tgt, tgt[None, :], (t, 0)
            )
            rec_pack = jax.lax.dynamic_update_slice(
                rec_pack, pack_of(lit, dst, tgt < n_out_pad)[None, :],
                (t, 0),
            )
            return rec_tgt, rec_pack, p, o, active, cache

        rec_tgt, rec_pack, _, _, _, _ = jax.lax.fori_loop(
            0, t_steps, step,
            (
                jnp.full((t_steps, lcount), n_out_pad, jnp.int32),
                jnp.zeros((t_steps, lcount), jnp.int32),
                p0, o0, lane_valid, cache0,
            ),
            unroll=_WALK_UNROLL,
        )
        packed = packed0.at[rec_tgt.reshape(-1)].max(
            rec_pack.reshape(-1), mode="drop"
        )
    else:
        # Per-lane sink slots keep the per-step scatter indices truly
        # unique (inactive lanes each park on their own slot).
        lane_sink = n_out_pad + jnp.arange(lcount, dtype=jnp.int32)
        packed_w = jnp.concatenate(
            [packed0, jnp.zeros((lcount,), jnp.int32)]
        )

        def step(t, state):
            packed_w, p, o, active, cache = state
            tgt, lit, dst, p, o, active, cache = decode_step(
                p, o, active, *cache
            )
            emit = tgt < n_out_pad
            idx = jnp.where(emit, tgt, lane_sink)
            packed_w = packed_w.at[idx].max(
                pack_of(lit, dst, emit), unique_indices=True
            )
            return packed_w, p, o, active, cache

        packed_w, _, _, _, _ = jax.lax.fori_loop(
            0, t_steps, step,
            (packed_w, p0, o0, lane_valid, cache0),
            unroll=_WALK_UNROLL,
        )
        packed = packed_w[:n_out_pad]

    posn = jnp.arange(n_out_pad, dtype=jnp.int32)
    litval = (packed >> 1) & 0xFF
    dist_at = packed >> 9
    start_mark = jnp.where((packed & 1) == 1, posn, -1)
    return litval, start_mark, dist_at


@functools.partial(
    jax.jit,
    static_argnames=(
        "n_out_pad", "n_stored", "t_steps", "with_crc", "defer"
    ),
)
def _walk_all(
    words, ll_first, ll_cnt, ll_off, ll_sym, d_first, d_cnt, d_off, d_sym,
    lane_bit, lane_out, lane_uid, lane_valid, prefix, stored_runs,
    crc_len, n_out_pad, n_stored, t_steps, with_crc,
    defer=True,
):
    """Single-group anchor-walk decode: walk + LZ resolve + fused CRC."""
    litval, start_mark, dist_at = _walk_core(
        words, ll_first, ll_cnt, ll_off, ll_sym, d_first, d_cnt, d_off,
        d_sym, lane_bit, lane_out, lane_uid, lane_valid, prefix,
        stored_runs, n_out_pad, n_stored, t_steps, defer,
    )
    out = _resolve_lz(litval, start_mark, dist_at, n_out_pad)
    if not with_crc:
        return out, jnp.uint32(0)
    # CRC of [_W, crc_len) fused into the same dispatch: the walk graph
    # is light enough to carry the tree-combine unroll (unlike the
    # per-bit graph, whose compile the extra unroll overloads).
    from zzflate_tpu.ops import checksums as cs

    return out, cs._crc32_impl(out, crc_len, jnp.int32(_W))


@functools.partial(
    jax.jit,
    static_argnames=(
        "n_out_pad", "n_stored", "t_steps", "with_crc", "defer"
    ),
)
def _walk_all_grouped(
    words, ll_first, ll_cnt, ll_off, ll_sym, d_first, d_cnt, d_off, d_sym,
    lane_bit, lane_out, lane_uid, lane_valid, prefix0, stored_runs,
    crc_len, go, n_out_pad, n_stored, t_steps, with_crc,
    defer=True,
):
    """All-groups anchor-walk decode in ONE dispatch.

    Every array carries a leading group axis. The walk and the LZ parent
    chase are byte-value-independent, so all groups run them in parallel
    under vmap (one t_steps token loop and one doubling chase TOTAL,
    instead of one sequential pair per ~4 MiB group); only the final
    litval[parent] byte-gather needs the previous group's decoded tail
    as its 32 KiB prefix, and that dependency is a G-step lax.scan of
    one gather + one slice per group, instead of one walk loop per
    group."""
    zero_prefix = jnp.zeros((_W,), jnp.uint8)

    def parents(w, lf, lc, lo, ls, df, dc, do_, ds, lb, lo2, lu, lv,
                sr):
        litval, start_mark, dist_at = _walk_core(
            w, lf, lc, lo, ls, df, dc, do_, ds, lb, lo2, lu, lv,
            zero_prefix, sr, n_out_pad, n_stored, t_steps, defer,
        )
        return litval, _resolve_parent(start_mark, dist_at, n_out_pad)

    litval, parent = jax.vmap(parents)(
        words, ll_first, ll_cnt, ll_off, ll_sym, d_first, d_cnt, d_off,
        d_sym, lane_bit, lane_out, lane_uid, lane_valid, stored_runs,
    )

    from zzflate_tpu.ops import checksums as cs

    def seam(carry, xs):
        lit_g, par_g, go_g, cl_g = xs
        lit_g = jax.lax.dynamic_update_slice(
            lit_g, carry.astype(jnp.int32), (0,)
        )
        out_g = lit_g[par_g].astype(jnp.uint8)
        crc_g = (
            cs._crc32_impl(out_g, cl_g, jnp.int32(_W))
            if with_crc
            else jnp.uint32(0)
        )
        # Positions [go, go+_W) are the next group's 32 KiB window (this
        # buffer's own [0,_W) prefix covers the short-output case).
        carry = jax.lax.dynamic_slice(out_g, (go_g,), (_W,))
        return carry, (out_g, crc_g)

    _, (outs, crcs) = jax.lax.scan(
        seam, prefix0, (litval, parent, go, crc_len)
    )
    return outs, crcs


def _pow2(n: int) -> int:
    return 1 << max(0, (n - 1)).bit_length()


def _lane_bucket(n: int) -> int:
    """Walk-lane padding bucket: two buckets per octave (p and 3p/4)
    instead of pow2 — the walk loop costs l_pad x t_steps lane-steps, so
    a stream one lane over a pow2 boundary no longer pays 2x (round-4
    verdict, decode item 3). Bounded compile count: <= 2 shapes/octave."""
    p = _pow2(n)
    if p >= 8 and n <= 3 * p // 4:
        return 3 * p // 4
    return p


# ---------------------------------------------------------------------------
# Public entry.
# ---------------------------------------------------------------------------


def decompress_indexed(
    data: bytes, verify: bool = True, to_device: bool = False
):
    """Chunk-parallel decode of an indexed gzip stream on device.

    Returns None if the stream carries no 'ZZ' index (caller falls
    back). With to_device=True, returns (jax.Array of uint8, length):
    the decoded bytes stay on device (data-loading path); CRC is still
    verified on device when verify=True.
    """
    parsed = containers.parse_gzip_index(data)
    if parsed is None:
        return None
    header_len, chunk_bytes, anchor_tokens, chunks = parsed
    # The indexed member's extent comes from the index itself, not from
    # the end of the buffer: a valid stream may append further gzip
    # members after it (RFC 1952 multi-member). Trailing members are
    # decoded by the native path and concatenated.
    member_len = header_len + sum(sz for sz, _b, _a in chunks) + 8
    if member_len > len(data):
        return None  # index inconsistent with buffer; fall back
    (crc_expect, isize) = struct.unpack(
        "<II", data[member_len - 8 : member_len]
    )
    tail = data[member_len:]
    if tail[:2] != b"\x1f\x8b":
        tail = b""  # trailing garbage is tolerated (gzip(1)/host-path behavior)
    nchunks = len(chunks)
    total_out = isize
    # Validate the (untrusted) index before any of it parameterizes device
    # shapes or jit arguments: a lying 'ZZ' subfield must raise ValueError,
    # never overflow int32 args or allocate absurd buffers (SURVEY.md 4.4).
    if not 1024 <= chunk_bytes <= (1 << 27):
        raise ValueError("ZZ index: implausible chunk_bytes")
    if isize > nchunks * chunk_bytes:
        raise ValueError("ZZ index: isize exceeds indexed chunk capacity")
    for sz, blocks, anchors in chunks:
        if sz > len(data) or len(blocks) > max(1, chunk_bytes // 1024):
            raise ValueError("ZZ index: implausible segment record")
        if len(anchors) > max(1, chunk_bytes // 64):
            raise ValueError("ZZ index: implausible anchor count")
        for bit_off, out_off in blocks + anchors:
            if bit_off >= 8 * max(sz, 1) or out_off > chunk_bytes:
                raise ValueError("ZZ index: block offsets out of range")
    # Anchor-walk decode requires the writer's spacing guarantee; an
    # absurd T from a hostile index must not size a compile.
    use_walk = 0 < anchor_tokens <= 4096

    if total_out > (1 << 30) or member_len - header_len - 8 > (1 << 30):
        return None  # host-memory sanity cap; native fallback

    out_sizes = [
        min(chunk_bytes, max(0, total_out - i * chunk_bytes))
        for i in range(nchunks)
    ]
    out_starts = [i * chunk_bytes for i in range(nchunks)]
    body = data[header_len : member_len - 8]

    # Partition chunks into groups: each group's compressed body and
    # decoded output fit one device graph, and every non-final group
    # shares the SAME compiled shape. The walk path only GATHERS from
    # the words buffer (no per-bit arrays), so its groups are bounded
    # by output size alone — sized so the padded output stays at 2^22;
    # the per-bit path is compile-bound at _GROUP_BITS of body.
    if use_walk:
        body_cap = _WGROUP_BODY
        out_cap = max(_WGROUP_OUT, chunk_bytes)
    else:
        body_cap = _GROUP_BODY
        out_cap = max(_GROUP_OUT, chunk_bytes)
    if any(sz > body_cap for sz, _b, _a in chunks):
        return None  # one chunk exceeds a device graph; native fallback
    cpos = [0]
    for sz, _b, _a in chunks:
        cpos.append(cpos[-1] + sz)
    groups: list[tuple[int, int]] = []
    lo = 0
    for i in range(nchunks):
        if (
            cpos[i + 1] - cpos[lo] > body_cap
            or (i + 1 - lo) * chunk_bytes > out_cap
        ) and i > lo:
            groups.append((lo, i))
            lo = i
    if lo < nchunks:
        groups.append((lo, nchunks))

    # Host walk of every group's block headers (tiny descriptors only).
    import bisect

    plans = []
    max_units = 1
    max_stored = 0
    max_lanes = 1
    try:
        for glo, ghi in groups:
            g_out_lo = out_starts[glo]
            units, sruns, uranges = _plan_units(
                body[cpos[glo] : cpos[ghi]],
                chunks[glo:ghi],
                [_W + out_starts[i] - g_out_lo for i in range(glo, ghi)],
                out_sizes[glo:ghi],
            )
            # Walk lanes: every block's first token + every index anchor
            # (rebased into the group's flat bit/output spaces), each
            # tagged with the unit whose tree decodes it.
            lanes: list[tuple[int, int, int]] = []
            if use_walk:
                for ci in range(glo, ghi):
                    ulo, uhi = uranges[ci - glo]
                    if ulo == uhi:
                        continue  # stored fallback: no token lanes
                    for u in range(ulo, uhi):
                        lanes.append(
                            (units[u].bit, units[u].out_base, u)
                        )
                    seg_bit0 = (cpos[ci] - cpos[glo]) * 8
                    outbase = _W + out_starts[ci] - g_out_lo
                    ustarts = [units[u].bit for u in range(ulo, uhi)]
                    for ab, ao in chunks[ci][2]:
                        bit = seg_bit0 + ab
                        k = bisect.bisect_right(ustarts, bit) - 1
                        if k < 0:
                            continue  # anchor before any token: bogus
                        lanes.append((bit, outbase + ao, ulo + k))
            if lanes:
                # A crafted 'ZZ' index can place an anchor exactly on a
                # block-first token; duplicate (bit, out) lanes would break
                # the non-defer walk's unique-index scatter promise. Dedupe
                # host-side (first occurrence wins; duplicates are
                # bit-identical walks anyway).
                seen: set[tuple[int, int]] = set()
                lanes = [
                    ln for ln in lanes
                    if (ln[0], ln[1]) not in seen
                    and not seen.add((ln[0], ln[1]))
                ]
            plans.append((glo, ghi, units, sruns, lanes))
            max_units = max(max_units, len(units))
            max_stored = max(max_stored, len(sruns))
            max_lanes = max(max_lanes, len(lanes))
    except (IndexError, struct.error) as e:
        # Host header parsing ran off the segment: the index lied.
        raise ValueError(f"corrupt indexed segment: {e}") from e

    # Shared static shapes so all groups hit one compiled graph.
    multi = len(groups) > 1
    max_body = max((cpos[hi] - cpos[lo] for lo, hi in groups), default=0)
    nbits = (
        _GROUP_BITS if multi else max(_RR, _pow2(max_body * 8 + 16))
    )
    max_go = max(
        (
            out_starts[hi - 1] + out_sizes[hi - 1] - out_starts[lo]
            for lo, hi in groups
        ),
        default=0,
    )
    n_out_pad = _pow2(_W + max(1, max_go))
    u_pad = _pow2(max_units)
    max_seg_bits = max((sz * 8 for sz, _b, _a in chunks), default=1)
    max_sup_span = min(nbits // _RR, max_seg_bits // _RR + 2)
    n_stored = _pow2(max_stored) if max_stored else 0
    if use_walk:
        nw = (body_cap if multi else _pow2(max(64, max_body))) // 4 + 2
    else:
        nw = nbits // 32 + 2
    l_pad = _lane_bucket(max_lanes)
    t_steps = anchor_tokens + 2  # spacing + EOB + slack

    from zzflate_tpu.ops import checksums as cs

    prefix = jnp.zeros((_W,), jnp.uint8)
    group_out: list[tuple[jax.Array, int]] = []  # (device buf, out bytes)
    group_crc: list[jax.Array] = []
    # Grouped mode: stage every group's numpy inputs, then decode ALL
    # groups in one stacked dispatch (_walk_all_grouped) instead of one
    # sequential walk per group.
    grouped = use_walk and _WALK_VMAP and len(plans) > 1
    staged: list[tuple] = []
    for glo, ghi, units, sruns0, lanes in plans:
        gbody = body[cpos[glo] : cpos[ghi]]
        go = (
            out_starts[ghi - 1] + out_sizes[ghi - 1] - out_starts[glo]
        )
        wbytes = gbody + b"\x00" * (nw * 4 - len(gbody))
        words = np.frombuffer(wbytes[: nw * 4], "<u4")
        ll_first = np.zeros((u_pad, 16), np.int32)
        ll_cnt = np.zeros((u_pad, 16), np.int32)
        ll_offs = np.zeros((u_pad, 16), np.int32)
        ll_sym = np.zeros((u_pad, _MAX_LL), np.int32)
        d_first = np.zeros((u_pad, 16), np.int32)
        d_cnt = np.zeros((u_pad, 16), np.int32)
        d_offs = np.zeros((u_pad, 16), np.int32)
        d_sym = np.zeros((u_pad, _MAX_D), np.int32)
        start_bits = np.zeros(u_pad, np.int32)
        out_bases = np.zeros(u_pad, np.int32)
        unit_valid = np.zeros(u_pad, bool)
        for j, un in enumerate(units):
            ll_first[j], ll_cnt[j], ll_offs[j], ll_sym[j] = un.ll
            d_first[j], d_cnt[j], d_offs[j], d_sym[j] = un.d
            start_bits[j] = un.bit
            out_bases[j] = un.out_base
            unit_valid[j] = True
        if n_stored:
            sr = np.zeros((n_stored, 3), np.int32)
            sr[:, 0] = n_out_pad  # padding rows: out of range, len 0
            for j, (op, so, ln) in enumerate(sruns0):
                sr[j] = (op, so, ln)
        else:
            sr = np.zeros((1, 3), np.int32)

        if use_walk:
            lane_bit = np.zeros(l_pad, np.int32)
            lane_out = np.zeros(l_pad, np.int32)
            lane_uid = np.zeros(l_pad, np.int32)
            lane_valid = np.zeros(l_pad, bool)
            for j, (lb, lo_, lu) in enumerate(lanes):
                lane_bit[j] = lb
                lane_out[j] = lo_
                lane_uid[j] = lu
                lane_valid[j] = True
            if grouped:
                staged.append((
                    words, ll_first, ll_cnt, ll_offs, ll_sym,
                    d_first, d_cnt, d_offs, d_sym,
                    lane_bit, lane_out, lane_uid, lane_valid,
                    sr, go,
                ))
                continue
            out_dev, crc_dev = _walk_all(
                jnp.asarray(words),
                jnp.asarray(ll_first), jnp.asarray(ll_cnt),
                jnp.asarray(ll_offs), jnp.asarray(ll_sym),
                jnp.asarray(d_first), jnp.asarray(d_cnt),
                jnp.asarray(d_offs), jnp.asarray(d_sym),
                jnp.asarray(lane_bit), jnp.asarray(lane_out),
                jnp.asarray(lane_uid), jnp.asarray(lane_valid), prefix,
                jnp.asarray(sr),
                jnp.asarray(_W + go, jnp.int32),
                n_out_pad=n_out_pad, n_stored=n_stored, t_steps=t_steps,
                with_crc=verify, defer=_WALK_DEFER,
            )
            if verify:
                group_crc.append(crc_dev)
        else:
            out_dev = _decode_all(
                jnp.asarray(words),
                jnp.asarray(ll_first), jnp.asarray(ll_cnt),
                jnp.asarray(ll_offs), jnp.asarray(ll_sym),
                jnp.asarray(d_first), jnp.asarray(d_cnt),
                jnp.asarray(d_offs), jnp.asarray(d_sym),
                jnp.asarray(start_bits), jnp.asarray(out_bases),
                jnp.asarray(unit_valid), prefix,
                jnp.asarray(sr),
                nbits=nbits, n_out_pad=n_out_pad,
                max_sup_span=max_sup_span, n_stored=n_stored,
            )
        group_out.append((out_dev, go))
        if verify and not use_walk:
            # Device-side CRC as its own dispatch over the padded buffer
            # (fixed shape -> one compiled graph for every group; the
            # tree-combine unroll stays out of the large PER-BIT decode
            # graph — the walk graph carries it fused instead).
            group_crc.append(
                cs._crc32_impl(
                    out_dev,
                    jnp.asarray(_W + go, jnp.int32),
                    jnp.asarray(_W, jnp.int32),
                )
            )
        if (glo, ghi) != groups[-1]:
            # Last 32 KiB of output-so-far: positions [go, go+_W) of this
            # buffer (its own [0,_W) prefix covers the short-output case).
            prefix = jax.lax.dynamic_slice(
                out_dev, (jnp.asarray(go, jnp.int32),), (_W,)
            )

    if grouped:
        gos = np.array([s[14] for s in staged], np.int32)
        ngroups = len(staged)
        # Pad the group axis to a power of two with inert groups (no
        # valid lanes, zero output) so every stream-size class in a
        # bucket shares ONE compiled graph — each distinct G would
        # otherwise cost its own compile.
        gp = _pow2(ngroups)
        padded = staged + [
            tuple(np.zeros_like(a) for a in staged[0][:14]) + (0,)
        ] * (gp - ngroups)
        gpos = np.concatenate([gos, np.zeros(gp - ngroups, np.int32)])
        outs, crcs = _walk_all_grouped(
            *(
                jnp.asarray(np.stack([s[i] for s in padded]))
                for i in range(13)
            ),
            prefix,
            jnp.asarray(np.stack([s[13] for s in padded])),
            jnp.asarray(_W + gpos), jnp.asarray(gpos),
            n_out_pad=n_out_pad, n_stored=n_stored, t_steps=t_steps,
            with_crc=verify, defer=_WALK_DEFER,
        )
        for gi in range(ngroups):
            group_out.append((outs[gi], int(gos[gi])))
            if verify:
                group_crc.append(crcs[gi])

    if verify:
        crc = 0
        vals = np.asarray(jnp.stack(group_crc)) if group_crc else []
        for v, (_buf, go) in zip(vals, group_out):
            crc = cs.crc32_combine(crc, int(v), go)
        if crc != crc_expect:
            raise ValueError("crc32 mismatch (device inflate)")

    if to_device:
        if tail:
            raise ValueError("to_device unsupported for multi-member gzip")
        if not group_out:
            return jnp.zeros((0,), jnp.uint8), 0
        if len(group_out) == 1:
            buf, go = group_out[0]
            return buf[_W : _W + total_out], total_out
        return (
            jnp.concatenate([buf[_W : _W + go] for buf, go in group_out]),
            total_out,
        )

    out = b"".join(
        _fetch_bytes(buf, go, base=_W) for buf, go in group_out
    )
    if verify and (len(out) & 0xFFFFFFFF) != (isize & 0xFFFFFFFF):
        raise ValueError("isize mismatch (device inflate)")
    if tail:
        from zzflate_tpu.models import inflate

        out += inflate.decompress(tail, format="gzip")
    return out


# Device->host fetch slice (bytes); env-tunable for transfer sweeps
# (bounded slices cap the host staging buffer; small ones pay fixed
# latency per fetch).
_FETCH_SLICE = int(os.environ.get("ZZFLATE_FETCH_SLICE", str(2 << 20)))


def _fetch_bytes(out_dev: jax.Array, total_out: int, base: int = 0) -> bytes:
    """Device->host in bounded slices of _FETCH_SLICE bytes."""
    if total_out == 0:
        return b""
    if total_out <= _FETCH_SLICE:
        return np.asarray(out_dev[base : base + total_out]).tobytes()
    parts = []
    for a in range(0, total_out, _FETCH_SLICE):
        b = min(a + _FETCH_SLICE, total_out)
        parts.append(np.asarray(out_dev[base + a : base + b]).tobytes())
    return b"".join(parts)


# ---------------------------------------------------------------------------
# Foreign (unindexed) streams: host anchor pre-scan -> device anchor walk.
#
# The indexed path needs the encoder's 'ZZ' FEXTRA; arbitrary
# zlib/gzip/raw streams carry no index, so the native C scanner
# (native.scan_anchors) walks the bitstream once WITHOUT materializing
# output and records exactly the lane set the anchor-walk kernel needs:
# every block's first token plus every ANCHOR_TOKENS-th token's
# (bit, out) position. The device then decodes all intervals in
# parallel with the same compiled graphs the indexed path uses
# (SURVEY.md C17: per-block parallel decode of arbitrary streams;
# round-3 verdict item #5).
# ---------------------------------------------------------------------------


def decompress_foreign(
    data: bytes,
    format: str = "gzip",
    verify: bool = True,
    to_device: bool = False,
):
    """Device decode of a foreign (unindexed) zlib/gzip/raw stream.

    Returns None when the stream is unsuitable (no native scanner, a
    preset dictionary, nothing but stored blocks, or size caps) — the
    caller falls back to the native C decoder. gzip CRC verifies on
    device; zlib Adler-32 verifies on the host bytes (fetch path only).
    """
    from zzflate_tpu import native as _native

    if _native.lib() is None:
        return None
    data = bytes(data)
    tail = b""
    crc_expect = isize = adler_expect = None
    if format == "gzip":
        header_len = containers.parse_gzip_header(data)
        body = data[header_len:]
    elif format == "zlib":
        header_len, dictid = containers.parse_zlib_header(data)
        if dictid is not None:
            return None  # device path has no preset-dictionary lanes
        body = data[header_len:]  # trailer located after the scan
    elif format == "raw":
        body = data
    else:
        raise ValueError(f"unknown format {format!r}")
    if len(body) > (1 << 30):
        return None

    T = C.ANCHOR_TOKENS
    try:
        blocks, anchors, total_out, end_bit = _native.scan_anchors(body, T)
    except ValueError:
        return None  # corrupt per the scanner: let native raise precisely
    if format == "zlib":
        # Adler-32 sits right after the final block (trailing bytes
        # beyond it are ignored, matching zlib.decompress).
        tr = header_len + (end_bit + 7) // 8
        if tr + 4 > len(data):
            raise ValueError("truncated zlib trailer")
        (adler_expect,) = struct.unpack(">I", data[tr : tr + 4])
    if format == "gzip":
        member_end = header_len + (end_bit + 7) // 8 + 8
        if member_end > len(data):
            raise ValueError("truncated gzip member")
        (crc_expect, isize) = struct.unpack(
            "<II", data[member_end - 8 : member_end]
        )
        tail = data[member_end:]
        if tail[:2] != b"\x1f\x8b":
            tail = b""  # trailing garbage tolerated (gzip(1)/host-path behavior)
        if isize != (total_out & 0xFFFFFFFF):
            raise ValueError("isize mismatch (device inflate)")
    if total_out > (1 << 30):
        return None
    nb = len(blocks)
    if nb == 0 or not (blocks[:, 1] != 0).any():
        return None  # all-stored stream: the native memcpy path wins

    # Partition blocks into groups bounded like the indexed walk path.
    out_cap = _WGROUP_OUT
    body_cap = _WGROUP_BODY
    out_ends = np.empty(nb, np.int64)
    out_ends[:-1] = blocks[1:, 2]
    out_ends[-1] = total_out
    bit_ends = np.empty(nb, np.int64)
    bit_ends[:-1] = blocks[1:, 0]
    bit_ends[-1] = end_bit
    if ((out_ends - blocks[:, 2]) > out_cap).any() or (
        (bit_ends - blocks[:, 0]) // 8 > body_cap
    ).any():
        return None  # one block exceeds a device graph
    groups: list[tuple[int, int]] = []  # [lo, hi) block ranges
    lo = 0
    for i in range(nb):
        if i > lo and (
            (bit_ends[i] // 8 - blocks[lo, 0] // 8) > body_cap
            or (out_ends[i] - blocks[lo, 2]) > out_cap
        ):
            groups.append((lo, i))
            lo = i
    if lo < nb:
        groups.append((lo, nb))

    # Per-group staging: units from block headers, stored bytes, lanes.
    import bisect

    plans = []
    max_units = 1
    max_stored = 0
    max_lanes = 1
    max_body = 0
    max_go = 1
    abit = anchors[:, 0]
    for glo, ghi in groups:
        byte_lo = int(blocks[glo, 0] // 8)
        byte_hi = int((bit_ends[ghi - 1] + 7) // 8)
        out_lo = int(blocks[glo, 2])
        go = int(out_ends[ghi - 1]) - out_lo
        units = []
        sruns: list[tuple[int, int, int]] = []
        ustarts: list[int] = []
        for bi in range(glo, ghi):
            bit0, btype, ostart, aux0, aux1 = (int(v) for v in blocks[bi])
            if btype == 0:
                if aux1:
                    sruns.append(
                        (_W + ostart - out_lo, aux0 - byte_lo, aux1)
                    )
                continue
            # parse the header at the absolute bit, then rebase below
            b = BitReader(body, bit0)
            b.bits(1)
            bt = b.bits(2)
            if bt == 1:
                lld, dd = _FixedDecs.get()
            else:
                lld, dd = _read_dynamic_tables(b)
            units.append(
                _Unit(
                    b.bitpos - 8 * byte_lo,
                    _W + ostart - out_lo,
                    _canon_desc(lld, _MAX_LL),
                    _canon_desc(dd, _MAX_D),
                )
            )
            ustarts.append(bit0)
        lanes = [
            (u.bit, u.out_base, j) for j, u in enumerate(units)
        ]
        a_lo = np.searchsorted(abit, blocks[glo, 0], side="left")
        a_hi = np.searchsorted(
            abit, bit_ends[ghi - 1], side="left"
        )
        for ai in range(int(a_lo), int(a_hi)):
            bit, aout = int(anchors[ai, 0]), int(anchors[ai, 1])
            k = bisect.bisect_right(ustarts, bit) - 1
            if k < 0:
                continue
            lanes.append(
                (bit - 8 * byte_lo, _W + aout - out_lo, k)
            )
        plans.append((byte_lo, byte_hi, out_lo, go, units, sruns, lanes))
        max_units = max(max_units, len(units))
        max_stored = max(max_stored, len(sruns))
        max_lanes = max(max_lanes, len(lanes))
        max_body = max(max_body, byte_hi - byte_lo)
        max_go = max(max_go, go)

    multi = len(plans) > 1
    n_out_pad = _pow2(_W + max_go)
    u_pad = _pow2(max_units)
    n_stored = _pow2(max_stored) if max_stored else 0
    nw = (body_cap if multi else _pow2(max(64, max_body))) // 4 + 2
    l_pad = _lane_bucket(max_lanes)
    t_steps = T + 2

    from zzflate_tpu.ops import checksums as cs

    prefix = jnp.zeros((_W,), jnp.uint8)
    group_out: list[tuple[jax.Array, int]] = []
    group_crc: list[jax.Array] = []
    grouped = _WALK_VMAP and multi
    staged: list[tuple] = []
    for byte_lo, byte_hi, out_lo, go, units, sruns0, lanes in plans:
        gbody = body[byte_lo:byte_hi]
        wbytes = gbody + b"\x00" * (nw * 4 - len(gbody))
        words = np.frombuffer(wbytes[: nw * 4], "<u4")
        ll_first = np.zeros((u_pad, 16), np.int32)
        ll_cnt = np.zeros((u_pad, 16), np.int32)
        ll_offs = np.zeros((u_pad, 16), np.int32)
        ll_sym = np.zeros((u_pad, _MAX_LL), np.int32)
        d_first = np.zeros((u_pad, 16), np.int32)
        d_cnt = np.zeros((u_pad, 16), np.int32)
        d_offs = np.zeros((u_pad, 16), np.int32)
        d_sym = np.zeros((u_pad, _MAX_D), np.int32)
        for j, un in enumerate(units):
            ll_first[j], ll_cnt[j], ll_offs[j], ll_sym[j] = un.ll
            d_first[j], d_cnt[j], d_offs[j], d_sym[j] = un.d
        if n_stored:
            sr = np.zeros((n_stored, 3), np.int32)
            sr[:, 0] = n_out_pad  # padding rows: out of range, len 0
            for j, (op, so, ln) in enumerate(sruns0):
                sr[j] = (op, so, ln)
        else:
            sr = np.zeros((1, 3), np.int32)
        lane_bit = np.zeros(l_pad, np.int32)
        lane_out = np.zeros(l_pad, np.int32)
        lane_uid = np.zeros(l_pad, np.int32)
        lane_valid = np.zeros(l_pad, bool)
        for j, (lb, lo_, lu) in enumerate(lanes):
            lane_bit[j] = lb
            lane_out[j] = lo_
            lane_uid[j] = lu
            lane_valid[j] = True
        if grouped:
            staged.append((
                words, ll_first, ll_cnt, ll_offs, ll_sym,
                d_first, d_cnt, d_offs, d_sym,
                lane_bit, lane_out, lane_uid, lane_valid,
                sr, go,
            ))
            continue
        out_dev, crc_dev = _walk_all(
            jnp.asarray(words),
            jnp.asarray(ll_first), jnp.asarray(ll_cnt),
            jnp.asarray(ll_offs), jnp.asarray(ll_sym),
            jnp.asarray(d_first), jnp.asarray(d_cnt),
            jnp.asarray(d_offs), jnp.asarray(d_sym),
            jnp.asarray(lane_bit), jnp.asarray(lane_out),
            jnp.asarray(lane_uid), jnp.asarray(lane_valid), prefix,
            jnp.asarray(sr),
            jnp.asarray(_W + go, jnp.int32),
            n_out_pad=n_out_pad, n_stored=n_stored, t_steps=t_steps,
            with_crc=verify and format == "gzip", defer=_WALK_DEFER,
        )
        if verify and format == "gzip":
            group_crc.append(crc_dev)
        group_out.append((out_dev, go))
        prefix = jax.lax.dynamic_slice(
            out_dev, (jnp.asarray(go, jnp.int32),), (_W,)
        )

    if grouped:
        gos = np.array([s[14] for s in staged], np.int32)
        ngroups = len(staged)
        gp = _pow2(ngroups)
        padded = staged + [
            tuple(np.zeros_like(a) for a in staged[0][:14]) + (0,)
        ] * (gp - ngroups)
        gpos = np.concatenate([gos, np.zeros(gp - ngroups, np.int32)])
        outs, crcs = _walk_all_grouped(
            *(
                jnp.asarray(np.stack([s[i] for s in padded]))
                for i in range(13)
            ),
            prefix,
            jnp.asarray(np.stack([s[13] for s in padded])),
            jnp.asarray(_W + gpos), jnp.asarray(gpos),
            n_out_pad=n_out_pad, n_stored=n_stored, t_steps=t_steps,
            with_crc=verify and format == "gzip", defer=_WALK_DEFER,
        )
        for gi in range(ngroups):
            group_out.append((outs[gi], int(gos[gi])))
            if verify and format == "gzip":
                group_crc.append(crcs[gi])

    if verify and format == "gzip":
        crc = 0
        vals = np.asarray(jnp.stack(group_crc)) if group_crc else []
        for v, (_buf, go) in zip(vals, group_out):
            crc = cs.crc32_combine(crc, int(v), go)
        if crc != crc_expect:
            raise ValueError("crc32 mismatch (device inflate)")

    if to_device:
        if tail:
            raise ValueError("to_device unsupported for multi-member gzip")
        if len(group_out) == 1:
            buf, go = group_out[0]
            return buf[_W : _W + total_out], total_out
        return (
            jnp.concatenate([buf[_W : _W + go] for buf, go in group_out]),
            total_out,
        )

    out = b"".join(
        _fetch_bytes(buf, go, base=_W) for buf, go in group_out
    )
    if verify and format == "zlib":
        if _native.adler32(out) != adler_expect:
            raise ValueError("adler32 mismatch (device inflate)")
    if tail:
        from zzflate_tpu.models import inflate

        out += inflate.decompress(tail, format="gzip")
    return out
