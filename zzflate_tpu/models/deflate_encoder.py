"""The jittable per-chunk DEFLATE block encoder — the flagship compute graph.

One call encodes one window-aligned chunk (with an optional 32 KiB
dictionary prefix) into a complete deflate block bitstream:

    match-find -> pointer-doubling parse -> per-position symbol fields ->
    masked histograms -> in-jit Huffman (dynamic) -> CL-RLE header ->
    fixed-vs-dynamic cost choice -> prefix-sum scatter bit-pack

Everything is static-shaped; tokens are never compacted — every input
position carries up to four (value, nbits) fields with nbits=0 when absent,
so the committed-token mask flows straight into the bit-packer's prefix sum
(SURVEY.md section 3.5's encode stack). The reference-class call stack this
replaces is SURVEY.md section 3.1 (compress -> LZ77 scan -> histogram ->
build trees -> emit), reorganized from a byte-serial loop into a dozen
data-parallel array passes.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from zzflate_tpu import constants as C
from zzflate_tpu.config import LevelParams
from zzflate_tpu.ops import bitpack, huffman, matcher

_CL_SLOTS = 340  # >= 286+30 RLE symbols + slack


# ---------------------------------------------------------------------------
# Closed-form symbol math. The RFC 1951 length/distance code tables (A.2/A.3)
# are power-of-two ramps: after the first linear run, each extra-bit level e
# holds a fixed count of codes spanning [base, base + 2^e) — so code, base
# and extra all fall out of the operand's bit length. Elementwise bit math
# fuses into its neighbours where a full-width gather is a memory pass of
# its own; these replace EVERY per-token table gather (the tables in
# constants.py remain the unit-test oracle).
# ---------------------------------------------------------------------------


def _bit_length(x: jax.Array) -> jax.Array:
    """bit_length(x) for x >= 1 (int32)."""
    return 32 - jax.lax.clz(x.astype(jnp.int32))


def _len_code(mlen: jax.Array) -> jax.Array:
    """LENGTH_TO_CODE[mlen] - 0 for mlen in [3, 258] (code 0..28)."""
    m = jnp.clip(mlen, 3, C.MAX_MATCH) - 3
    bl = _bit_length(jnp.maximum(m, 1))
    hi = 4 * (bl - 2) + ((m >> jnp.maximum(bl - 3, 0)) & 3)
    return jnp.where(
        mlen >= C.MAX_MATCH, 28, jnp.where(m < 8, m, hi)
    ).astype(jnp.int32)


def _len_extra_base(lcode: jax.Array):
    """(extra_bits, base_length) of a length code 0..28."""
    e = jnp.maximum((lcode >> 2) - 1, 0)
    base = jnp.where(
        lcode < 4, lcode + 3, 3 + ((4 + (lcode & 3)) << e)
    )
    ext = jnp.where((lcode < 4) | (lcode >= 28), 0, e)
    base = jnp.where(lcode >= 28, C.MAX_MATCH, base)
    return ext.astype(jnp.int32), base.astype(jnp.int32)


def _dist_code(mdist: jax.Array) -> jax.Array:
    """Distance code 0..29 for mdist in [1, 32768]."""
    n = jnp.maximum(mdist, 1) - 1
    bl = _bit_length(jnp.maximum(n, 1))
    hi = 2 * (bl - 1) + ((n >> jnp.maximum(bl - 2, 0)) & 1)
    return jnp.where(n < 4, n, hi).astype(jnp.int32)


def _dist_extra_base(dcode: jax.Array):
    """(extra_bits, base_distance) of a distance code 0..29."""
    e = jnp.maximum((dcode >> 1) - 1, 0)
    base = jnp.where(dcode < 4, dcode + 1, 1 + ((2 + (dcode & 1)) << e))
    ext = jnp.where(dcode < 4, 0, e)
    return ext.astype(jnp.int32), base.astype(jnp.int32)

_FIXED_LL_LEN = C.fixed_litlen_lengths()
_FIXED_LL_CODE = C.bit_reverse(
    C.canonical_codes(_FIXED_LL_LEN), _FIXED_LL_LEN
).astype(np.uint32)
_FIXED_D_LEN = C.fixed_dist_lengths()
_FIXED_D_CODE = C.bit_reverse(
    C.canonical_codes(_FIXED_D_LEN), _FIXED_D_LEN
).astype(np.uint32)


def _cl_rle(combined: jax.Array, total: jax.Array):
    """RLE-encode the transmitted code-length array (RFC 1951 3.2.7).

    combined: (316,) int32 lengths (entries >= total are ignored).
    Returns (syms, extra_val, extra_bits, count): (_CL_SLOTS,) arrays + ptr.
    """
    n_in = combined.shape[0]

    def get(i):
        return combined[jnp.clip(i, 0, n_in - 1)]

    def body(i, state):
        prevlen, count, ptr, syms, ev, eb = state
        active = i < total
        curlen = get(i)
        nextlen = jnp.where(i + 1 < total, get(i + 1), -1)
        count = count + jnp.where(active, 1, 0)
        maxc = jnp.where(curlen == 0, 138, 6)
        cont = active & (curlen == nextlen) & (count < maxc)
        flush = active & ~cont

        is_zero = curlen == 0
        emit_cur = flush & ~is_zero & (curlen != prevlen)
        r = count - jnp.where(emit_cur, 1, 0)
        use16 = flush & ~is_zero & (r >= 3)
        use18 = flush & is_zero & (count >= 11)
        use17 = flush & is_zero & (count >= 3) & ~use18
        rep = use16 | use17 | use18
        lit_reps = jnp.where(
            flush & ~rep, jnp.where(is_zero, count, r), 0
        )

        # Slot A: the literal curlen announcing a new value.
        pa = jnp.where(emit_cur, ptr, _CL_SLOTS)
        syms = syms.at[pa].set(curlen, mode="drop")
        ptr = ptr + jnp.where(emit_cur, 1, 0)
        # Slot B: repeat symbol, or first literal repetition.
        wb = rep | (lit_reps >= 1)
        pb = jnp.where(wb, ptr, _CL_SLOTS)
        sym_b = jnp.where(
            use16, 16, jnp.where(use17, 17, jnp.where(use18, 18, curlen))
        )
        ev_b = jnp.where(
            use16, r - 3, jnp.where(use17, count - 3, jnp.where(use18, count - 11, 0))
        )
        eb_b = jnp.where(use16, 2, jnp.where(use17, 3, jnp.where(use18, 7, 0)))
        syms = syms.at[pb].set(sym_b, mode="drop")
        ev = ev.at[pb].set(ev_b, mode="drop")
        eb = eb.at[pb].set(eb_b, mode="drop")
        ptr = ptr + jnp.where(wb, 1, 0)
        # Slot C: second literal repetition.
        wc = lit_reps >= 2
        pc = jnp.where(wc, ptr, _CL_SLOTS)
        syms = syms.at[pc].set(curlen, mode="drop")
        ptr = ptr + jnp.where(wc, 1, 0)

        prevlen = jnp.where(flush, curlen, prevlen)
        count = jnp.where(flush, 0, count)
        return prevlen, count, ptr, syms, ev, eb

    init = (
        jnp.int32(-1),
        jnp.int32(0),
        jnp.int32(0),
        jnp.zeros((_CL_SLOTS,), jnp.int32),
        jnp.zeros((_CL_SLOTS,), jnp.int32),
        jnp.zeros((_CL_SLOTS,), jnp.int32),
    )
    _, _, ptr, syms, ev, eb = jax.lax.fori_loop(0, n_in, body, init)
    return syms, ev, eb, ptr


def _encode_impl(
    data: jax.Array,
    start: jax.Array,
    valid_end: jax.Array,
    window_start: jax.Array,
    bfinal: jax.Array,
    params: LevelParams,
    out_words: int,
    huffman_only: bool = False,
    fixed_only: bool = False,
):
    """Encode data[start:valid_end] as one deflate block (BFINAL=bfinal).

    data[window_start:start] is dictionary/halo context (match sources
    only); bytes outside [window_start, valid_end) are padding.

    Returns dict with words (uint32 buffer), nbits, ntokens, cost_fixed,
    cost_dynamic (all device scalars/arrays).
    """
    n = data.shape[0]
    pos = jnp.arange(n, dtype=jnp.int32)

    if huffman_only:
        mlen = jnp.zeros((n,), jnp.int32)
        mdist = jnp.zeros((n,), jnp.int32)
    else:
        mlen, mdist = matcher.find_matches(
            data, valid_end, window_start, params.candidates,
            key_words=params.key_words,
        )
    committed, take = matcher.parse_commit(
        mlen,
        mdist,
        start,
        valid_end,
        lazy=params.lazy_mode,
        max_lazy=params.max_lazy,
        nice=params.nice,
    )
    is_match = take
    is_lit = committed & ~take

    # Per-position symbols (closed-form, no gathers).
    lcode = _len_code(mlen)
    dcode = _dist_code(mdist)
    litlen_sym = jnp.where(is_match, 257 + lcode, data.astype(jnp.int32))

    # Histograms (EOB counted once; small alphabets forced to >=2 used
    # symbols / >=1 dist code so decoders always see a sane tree).
    freq_ll = huffman.histogram(litlen_sym, committed, C.NUM_LITLEN_SYMBOLS)
    freq_ll = freq_ll.at[C.END_OF_BLOCK].add(1)
    freq_d = huffman.histogram(dcode, is_match, C.NUM_DIST_SYMBOLS)
    used_ll = jnp.sum((freq_ll > 0).astype(jnp.int32))
    freq_ll = freq_ll.at[0].set(
        jnp.maximum(freq_ll[0], (used_ll < 2).astype(jnp.int32))
    )
    used_d = jnp.sum((freq_d > 0).astype(jnp.int32))
    freq_d = freq_d.at[0].set(
        jnp.maximum(freq_d[0], (used_d < 1).astype(jnp.int32))
    )
    used_d2 = jnp.sum((freq_d > 0).astype(jnp.int32))
    freq_d = freq_d.at[1].set(
        jnp.maximum(freq_d[1], (used_d2 < 2).astype(jnp.int32))
    )

    # Dynamic trees.
    ll_len_dyn = huffman.code_lengths(freq_ll, C.MAX_CODE_BITS)
    d_len_dyn = huffman.code_lengths(freq_d, C.MAX_CODE_BITS)
    ll_code_dyn = huffman.canonical_codes(ll_len_dyn, C.MAX_CODE_BITS)
    d_code_dyn = huffman.canonical_codes(d_len_dyn, C.MAX_CODE_BITS)

    # Transmitted-lengths array and its RLE.
    sym286 = jnp.arange(286, dtype=jnp.int32)
    hlit = jnp.maximum(257, 1 + jnp.max(jnp.where(ll_len_dyn[:286] > 0, sym286, -1)))
    sym30 = jnp.arange(30, dtype=jnp.int32)
    hdist = jnp.maximum(1, 1 + jnp.max(jnp.where(d_len_dyn[:30] > 0, sym30, -1)))
    idx316 = jnp.arange(316, dtype=jnp.int32)
    combined = jnp.where(
        idx316 < hlit,
        jnp.take(ll_len_dyn, jnp.clip(idx316, 0, 285), mode="clip"),
        jnp.take(d_len_dyn, jnp.clip(idx316 - hlit, 0, 29), mode="clip"),
    )
    total_cl = hlit + hdist
    cl_syms, cl_ev, cl_eb, cl_count = _cl_rle(combined, total_cl)
    cl_slot_valid = jnp.arange(_CL_SLOTS) < cl_count

    freq_cl = huffman.histogram(cl_syms, cl_slot_valid, C.NUM_CL_SYMBOLS)
    cl_len = huffman.code_lengths(freq_cl, C.MAX_CL_CODE_BITS)
    cl_code = huffman.canonical_codes(cl_len, C.MAX_CL_CODE_BITS)

    cl_order = jnp.asarray(C.CL_ORDER)
    perm_len = cl_len[cl_order]  # lengths in transmission order
    j19 = jnp.arange(19, dtype=jnp.int32)
    hclen = jnp.maximum(4, 1 + jnp.max(jnp.where(perm_len > 0, j19, -1)))

    # Costs (extra bits are common to both block types).
    ll_len_fix = jnp.asarray(_FIXED_LL_LEN)
    d_len_fix = jnp.asarray(_FIXED_D_LEN)
    body_dyn = jnp.sum(freq_ll * ll_len_dyn) + jnp.sum(freq_d * d_len_dyn)
    body_fix = jnp.sum(freq_ll * ll_len_fix) + jnp.sum(freq_d * d_len_fix)
    hdr_dyn = (
        14
        + 3 * hclen
        + jnp.sum(
            jnp.where(cl_slot_valid, cl_len[jnp.clip(cl_syms, 0, 18)] + cl_eb, 0)
        )
    )
    extra_bits_total = jnp.sum(
        jnp.where(
            is_match,
            _len_extra_base(lcode)[0] + _dist_extra_base(dcode)[0],
            0,
        )
    )
    cost_dyn = 3 + hdr_dyn + body_dyn + extra_bits_total
    cost_fix = 3 + body_fix + extra_bits_total
    if fixed_only:
        use_dyn = jnp.bool_(False)
    else:
        use_dyn = cost_dyn < cost_fix

    ll_len = jnp.where(use_dyn, ll_len_dyn, ll_len_fix)
    ll_code_sel = jnp.where(use_dyn, ll_code_dyn, jnp.asarray(_FIXED_LL_CODE))
    d_len = jnp.where(use_dyn, d_len_dyn, d_len_fix)
    d_code_sel = jnp.where(use_dyn, d_code_dyn, jnp.asarray(_FIXED_D_CODE))
    dyn_mask = use_dyn.astype(jnp.int32)

    # ---- Field stream assembly ----
    # Header: BFINAL, BTYPE, [HLIT, HDIST, HCLEN, 19 CL lens, RLE stream].
    hdr_vals = [bfinal.astype(jnp.uint32), jnp.where(use_dyn, 2, 1).astype(jnp.uint32)]
    hdr_bits = [jnp.int32(1), jnp.int32(2)]
    for v, b in (
        ((hlit - 257).astype(jnp.uint32), 5),
        ((hdist - 1).astype(jnp.uint32), 5),
        ((hclen - 4).astype(jnp.uint32), 4),
    ):
        hdr_vals.append(v)
        hdr_bits.append(jnp.int32(b) * dyn_mask)
    hdr_v = jnp.stack(hdr_vals)
    hdr_b = jnp.stack(hdr_bits)

    clh_v = perm_len.astype(jnp.uint32)
    clh_b = jnp.where(j19 < hclen, 3, 0) * dyn_mask

    cl_sym_safe = jnp.clip(cl_syms, 0, 18)
    rle_code_v = cl_code[cl_sym_safe]
    rle_code_b = jnp.where(cl_slot_valid, cl_len[cl_sym_safe], 0) * dyn_mask
    rle_ex_v = cl_ev.astype(jnp.uint32)
    rle_ex_b = jnp.where(cl_slot_valid, cl_eb, 0) * dyn_mask
    rle_v = jnp.stack([rle_code_v, rle_ex_v], axis=1).reshape(-1)
    rle_b = jnp.stack([rle_code_b, rle_ex_b], axis=1).reshape(-1)

    # Tokens: per position [litlen code, len extra, dist code, dist extra].
    lsym_safe = jnp.clip(litlen_sym, 0, C.NUM_LITLEN_SYMBOLS - 1)
    dsym_safe = jnp.clip(dcode, 0, C.NUM_DIST_SYMBOLS - 1)
    f0_v = ll_code_sel[lsym_safe]
    f0_b = jnp.where(committed, ll_len[lsym_safe], 0)
    lext, lbase = _len_extra_base(lcode)
    f1_v = (mlen - lbase).astype(jnp.uint32)
    f1_b = jnp.where(is_match, lext, 0)
    f2_v = d_code_sel[dsym_safe]
    f2_b = jnp.where(is_match, d_len[dsym_safe], 0)
    dext, dbase = _dist_extra_base(dsym_safe)
    f3_v = (mdist - dbase).astype(jnp.uint32)
    f3_b = jnp.where(is_match, dext, 0)
    tok_v = jnp.stack([f0_v, f1_v, f2_v, f3_v], axis=1).reshape(-1)
    tok_b = jnp.stack([f0_b, f1_b, f2_b, f3_b], axis=1).reshape(-1)

    eob_v = ll_code_sel[C.END_OF_BLOCK][None]
    eob_b = ll_len[C.END_OF_BLOCK][None]

    values = jnp.concatenate([hdr_v, clh_v, rle_v, tok_v, eob_v])
    nbits = jnp.concatenate([hdr_b, clh_b, rle_b, tok_b, eob_b]).astype(jnp.int32)

    words, total_bits = bitpack.pack_fields(values, nbits, out_words)
    return {
        "words": words,
        "nbits": total_bits,
        "ntokens": jnp.sum(committed.astype(jnp.int32)),
        "cost_fixed": cost_fix,
        "cost_dynamic": cost_dyn,
        "used_dynamic": use_dyn,
    }


encode_chunk = functools.partial(
    jax.jit,
    static_argnames=("params", "out_words", "huffman_only", "fixed_only"),
)(_encode_impl)


# ---------------------------------------------------------------------------
# Two-phase pipeline (the production path).
#
# The fully-fused _encode_impl runs the two-queue Huffman merge and the
# CL-RLE scan as fori_loops of ~600 tiny sequential steps on device. The
# production path uses the split the reference-class codec has (tree
# build is negligible scalar work, SURVEY.md C10): phase 1 computes token
# histograms on device (288+30 ints to host), the host builds the code
# tables and the dynamic header field stream (microseconds of numpy),
# and phase 2 packs the bitstream on device from phase 1's
# device-resident token arrays with the supplied tables.
# ---------------------------------------------------------------------------

HDR_SLOTS = 672  # 5 fixed fields + 19 CL lengths + 2*316 RLE fields + pad

# Each chunk is emitted as ceil(chunk/SUB_BLOCK) deflate blocks with their
# own Huffman trees (the reference-class block segmenter C13 adapts trees
# every ~60-200 KB; a single tree per 256 KiB chunk costs ~1% ratio on
# mixed data). Sub-blocks partition the TOKEN positions; the LZ window
# crosses block boundaries freely per RFC 1951.
SUB_BLOCK = 1 << 16
_WIN = 32768

# v3 index anchors: one slot per ANCHOR_TOKENS committed tokens of each
# sub-block (a sub-block of 65536 positions holds at most 64 intervals).
_A_PB = SUB_BLOCK // C.ANCHOR_TOKENS


def anchor_slots(chunk_bytes: int) -> int:
    return sub_block_count(chunk_bytes) * _A_PB


def sub_block_count(chunk_bytes: int) -> int:
    return max(1, chunk_bytes // SUB_BLOCK)


def sub_block_bounds(n: int) -> list[int]:
    """Static token-range boundaries [W .. n] for a (W+chunk,) buffer."""
    chunk = n - _WIN
    sb = sub_block_count(chunk)
    return [_WIN + (b * chunk) // sb for b in range(sb)] + [n]


def _tokenize(data, start, valid_end, window_start, params, huffman_only,
              strategy=0, max_dist=32768):
    """Shared match+parse+symbol computation (device).

    strategy follows the zlib.h:196-200 contract (SURVEY.md C20):
    2=HUFFMAN_ONLY (no matches, handled via huffman_only), 3=RLE (dist-1
    matches only), 1=FILTERED (drop short matches). max_dist < 32768
    implements reduced windowBits by post-filtering far matches.
    """
    if huffman_only:
        n = data.shape[0]
        mlen = jnp.zeros((n,), jnp.int32)
        mdist = jnp.zeros((n,), jnp.int32)
    else:
        mlen, mdist = matcher.find_matches(
            data, valid_end, window_start, params.candidates,
            key_words=params.key_words,
        )
        drop = jnp.zeros_like(mlen, dtype=bool)
        if strategy == 3:  # Z_RLE: only run matches at distance one
            drop = drop | (mdist != 1)
        elif strategy == 1:  # Z_FILTERED: skip short matches
            drop = drop | (mlen < 5)
        if max_dist < 32768:
            drop = drop | (mdist > max_dist)
        mlen = jnp.where(drop, 0, mlen)
        mdist = jnp.where(drop, 0, mdist)
    committed, take = matcher.parse_commit(
        mlen,
        mdist,
        start,
        valid_end,
        lazy=params.lazy_mode,
        max_lazy=params.max_lazy,
        nice=params.nice,
    )
    is_match = take
    lcode = _len_code(mlen)
    dcode = _dist_code(mdist)
    litlen_sym = jnp.where(is_match, 257 + lcode, data.astype(jnp.int32))
    return committed, is_match, litlen_sym, lcode, dcode, mlen, mdist


@functools.partial(
    jax.jit,
    static_argnames=(
        "params", "huffman_only", "with_checksums", "strategy", "max_dist"
    ),
)
def analyze_chunks_batch(data, starts, valid_ends, window_starts, params,
                         huffman_only=False, with_checksums=False,
                         strategy=0, max_dist=32768):
    """Phase 1 (device): match + parse + histograms on a (B, N) batch.

    The matcher is vmapped (independent per-chunk sorts); the parse runs
    BATCH-FLAT through matcher.parse_commit_batch — its serial row sweeps
    must see all chunks as one wide lane axis, not a vmapped loop (the
    fori_loop lanes are nearly free, vmap-lifted fat passes are not).
    The small freq arrays go to the host for the table build; the big
    per-position arrays stay device-resident and feed phase 2 directly
    (match finding is the dominant cost — never recompute it)."""
    bch, n = data.shape
    if huffman_only:
        mlen = jnp.zeros((bch, n), jnp.int32)
        mdist = jnp.zeros((bch, n), jnp.int32)
    else:
        mlen, mdist = jax.vmap(
            lambda d, ve, ws: matcher.find_matches(
                d, ve, ws, params.candidates, key_words=params.key_words
            )
        )(data, valid_ends, window_starts)
        drop = jnp.zeros_like(mlen, dtype=bool)
        if strategy == 3:  # Z_RLE: only run matches at distance one
            drop = drop | (mdist != 1)
        elif strategy == 1:  # Z_FILTERED: skip short matches
            drop = drop | (mlen < 5)
        if max_dist < 32768:
            drop = drop | (mdist > max_dist)
        mlen = jnp.where(drop, 0, mlen)
        mdist = jnp.where(drop, 0, mdist)

    committed, take = matcher.parse_commit_batch(
        mlen, mdist, starts, valid_ends,
        lazy=params.lazy_mode, max_lazy=params.max_lazy, nice=params.nice,
    )
    is_match = take

    lcode = _len_code(mlen)
    dcode = _dist_code(mdist)
    litlen_sym = jnp.where(is_match, 257 + lcode, data.astype(jnp.int32))

    bounds = sub_block_bounds(n)

    def chunk_hists(sym, com, ism, dc):
        fll = jnp.stack([
            huffman.histogram(sym[s:e], com[s:e], C.NUM_LITLEN_SYMBOLS)
            for s, e in zip(bounds[:-1], bounds[1:])
        ])
        fd = jnp.stack([
            huffman.histogram(dc[s:e], ism[s:e], C.NUM_DIST_SYMBOLS)
            for s, e in zip(bounds[:-1], bounds[1:])
        ])
        return fll, fd

    freq_ll, freq_d = jax.vmap(chunk_hists)(
        litlen_sym, committed, is_match, dcode
    )
    out = {
        "freq_ll": freq_ll,  # (B, SB, 288)
        "freq_d": freq_d,    # (B, SB, 30)
        # One packed buffer so the host needs a single device->host
        # fetch per batch: [..., :288] = freq_ll, [..., 288:] = freq_d.
        "freqs": jnp.concatenate([freq_ll, freq_d], axis=2),
        "committed": committed,
        "is_match": is_match,
        "litlen_sym": litlen_sym,
        "lcode": lcode,
        "dcode": dcode,
        "mlen": mlen,
        "mdist": mdist,
    }
    if params.optimal:
        # The host optimal-parse DP (levels 7-9) reads the raw candidate
        # arrays; pack (mlen <= 258, mdist <= 32768) into one int32 so
        # the host fetches half the bytes in one roundtrip.
        out["mm_packed"] = (mlen << jnp.int32(16)) | mdist
    if with_checksums:
        from zzflate_tpu.ops import checksums as cs

        out["adler"] = jax.vmap(
            lambda d, e, s: cs._adler32_impl(d, e, s)
        )(data, valid_ends, starts)
        out["crc"] = jax.vmap(
            lambda d, e, s: cs._crc32_impl(d, e, s)
        )(data, valid_ends, starts)
        # Same single-fetch packing: [:, 0] = adler, [:, 1] = crc.
        out["cks"] = jnp.stack([out["adler"], out["crc"]], axis=1)
    return out


def token_budget(chunk_bytes: int) -> int:
    """Static token-slot count for the compact emit graph: half the
    position width. A chunk with more committed tokens than this (avg
    token covers < 2 bytes — data that barely LZ-compresses) is routed
    to the full-width emit graph by the host instead."""
    return (_WIN + chunk_bytes) // 2


def _emit_compact(
    committed, is_match, litlen_sym, lcode, dcode, mlen, mdist,
    ll_len, ll_code, d_len, d_code, hdr_vals, hdr_nbits, eob_v, eob_nb,
    out_words, with_anchors, wc,
):
    """Token-compacted emit (see _emit_impl docstring, token_slots > 0).

    Layout: one full-width scatter builds tokpos (committed position of
    every dense token slot); two half-width gathers fetch the per-token
    fields as two packed ints; every later pass (table gathers, bit
    cumsum, three-word scatter-pack, anchors) runs at token width."""
    n = committed.shape[0]
    sb = ll_len.shape[0]
    bounds = sub_block_bounds(n)
    pos = jnp.arange(n, dtype=jnp.int32)

    com_i = committed.astype(jnp.int32)
    ctok = jnp.cumsum(com_i)               # inclusive committed count
    excl_tok = ctok - com_i                # dense slot of the token at p
    ntokens = ctok[n - 1]

    slot = jnp.where(committed, excl_tok, wc)
    tokpos = jnp.full((wc,), n, jnp.int32).at[slot].set(pos, mode="drop")

    # Packed per-position fields: pk1 = sym|lcode|dcode|is_match|committed
    # (21 bits), pk2 = mlen|mdist (25 bits) — two gathers, not seven.
    pk1 = (
        litlen_sym
        | (lcode << 9)
        | (dcode << 14)
        | (is_match.astype(jnp.int32) << 19)
        | (com_i << 20)
    )
    pk2 = (mlen << 16) | mdist
    g1 = jnp.take(pk1, tokpos, mode="fill", fill_value=0)
    g2 = jnp.take(pk2, tokpos, mode="fill", fill_value=0)
    c_sym = g1 & 0x1FF
    c_lcode = (g1 >> 9) & 0x1F
    c_dcode = (g1 >> 14) & 0x1F
    c_ism = ((g1 >> 19) & 1) == 1
    c_com = ((g1 >> 20) & 1) == 1
    c_mlen = g2 >> 16
    c_mdist = g2 & 0xFFFF

    c_tb = jnp.zeros((wc,), jnp.int32)
    for b in range(1, sb):
        c_tb = c_tb + (tokpos >= bounds[b]).astype(jnp.int32)

    lsym_safe = jnp.clip(c_sym, 0, C.NUM_LITLEN_SYMBOLS - 1)
    dsym_safe = jnp.clip(c_dcode, 0, C.NUM_DIST_SYMBOLS - 1)
    ll_pack = ll_code.astype(jnp.uint32) | (ll_len.astype(jnp.uint32) << 20)
    d_pack = d_code.astype(jnp.uint32) | (d_len.astype(jnp.uint32) << 20)
    e0 = ll_pack[c_tb, lsym_safe]
    f0_v = e0 & jnp.uint32(0xFFFFF)
    f0_b = jnp.where(c_com, (e0 >> 20).astype(jnp.int32), 0)
    e2 = d_pack[c_tb, dsym_safe]
    f2_v = e2 & jnp.uint32(0xFFFFF)
    f2_b = jnp.where(c_ism, (e2 >> 20).astype(jnp.int32), 0)
    lext, lbase = _len_extra_base(c_lcode)
    f1_v = (c_mlen - lbase).astype(jnp.uint32)
    f1_b = jnp.where(c_ism, lext, 0)
    dext, dbase = _dist_extra_base(dsym_safe)
    f3_v = (c_mdist - dbase).astype(jnp.uint32)
    f3_b = jnp.where(c_ism, dext, 0)

    # 48-bit field merge — identical math to the full-width path.
    def _mask(v, b):
        return v.astype(jnp.uint32) & (
            (jnp.uint32(1) << b.astype(jnp.uint32)) - 1
        )

    f0m = _mask(f0_v, f0_b)
    f1m = _mask(f1_v, f1_b)
    f2m = _mask(f2_v, f2_b)
    f3m = _mask(f3_v, f3_b)
    m0_v = f0m | (f1m << f0_b.astype(jnp.uint32))
    m0_b = f0_b + f1_b
    m1_v = f2m | (f3m << f2_b.astype(jnp.uint32))
    m1_b = f2_b + f3_b
    m0u = m0_b.astype(jnp.uint32)
    lo48 = m0_v | (m1_v << m0u)
    hi48 = (m1_v >> (jnp.uint32(31) - m0u)) >> jnp.uint32(1)

    tw = (m0_b + m1_b).astype(jnp.int32)
    cum = jnp.cumsum(tw)
    excl = cum - tw
    hdr_tot = jnp.sum(hdr_nbits, axis=1).astype(jnp.int32)  # (SB,)
    eob_b32 = eob_nb.astype(jnp.int32)

    # Slot id of the first token at/after each sub-block boundary.
    nb4 = jnp.stack([excl_tok[bounds[b]] for b in range(sb)])
    cum_pad = jnp.concatenate([excl, cum[-1:]])  # [wc] = total token bits
    nb4c = jnp.clip(nb4, 0, wc)
    S = cum_pad[nb4c]
    total_tok = cum[wc - 1]
    T = jnp.concatenate([S[1:], total_tok[None]]) - S
    seg = hdr_tot + T + eob_b32
    hdr_base = jnp.cumsum(seg) - seg
    total_bits = hdr_base[sb - 1] + seg[sb - 1]
    sb_bits = hdr_base

    add = jnp.zeros((), jnp.int32)
    for b in range(sb):
        const_b = hdr_base[b] + hdr_tot[b] - S[b]
        add = jnp.where(tokpos >= bounds[b], const_b, add)
    off0 = excl + add

    words = jnp.zeros((out_words,), jnp.uint32)
    words = bitpack.scatter_field48(words, off0, lo48, hi48, tw, out_words)
    hdr_off = (
        jnp.cumsum(hdr_nbits, axis=1) - hdr_nbits + hdr_base[:, None]
    )
    eob_off = hdr_base + hdr_tot + T
    words = bitpack.scatter_fields(
        words, hdr_off.reshape(-1), hdr_vals.reshape(-1).astype(jnp.uint32),
        hdr_nbits.reshape(-1), out_words,
    )
    words = bitpack.scatter_fields(
        words, eob_off, eob_v.astype(jnp.uint32), eob_b32, out_words
    )

    outlen = jnp.where(
        c_ism, c_mlen, jnp.where(c_com, 1, 0)
    ).astype(jnp.int32)
    outc = jnp.cumsum(outlen)
    out_excl_c = outc - outlen
    out_pad = jnp.concatenate([out_excl_c, outc[-1:]])
    sb_out = out_pad[nb4c]

    a_total = sb * _A_PB
    if with_anchors:
        slot_idx = jnp.arange(wc, dtype=jnp.int32)
        csub = jnp.zeros((), jnp.int32)
        for b in range(sb):
            csub = jnp.where(tokpos >= bounds[b], nb4[b], csub)
        o_b = slot_idx - csub
        t_anchor = C.ANCHOR_TOKENS
        is_anchor = c_com & (o_b > 0) & (o_b % t_anchor == 0)
        aslot = jnp.where(
            is_anchor, c_tb * _A_PB + (o_b // t_anchor - 1), a_total
        )
        anc_bit = jnp.full((a_total,), -1, jnp.int32).at[aslot].set(
            off0, mode="drop"
        )
        anc_out = jnp.full((a_total,), -1, jnp.int32).at[aslot].set(
            out_excl_c, mode="drop"
        )
    else:
        anc_bit = jnp.full((a_total,), -1, jnp.int32)
        anc_out = jnp.full((a_total,), -1, jnp.int32)

    # Defense in depth: a chunk that overflowed its token budget (host
    # gating bug) must never ship a truncated stream — poison nbits so
    # the stitcher's stored fallback wins and keep_bits_max zeroes it.
    total_bits = jnp.where(ntokens > wc, jnp.int32(1 << 30), total_bits)
    return {
        "words": words,
        "nbits": total_bits,
        "ntokens": ntokens,
        "sb_bits": sb_bits,
        "sb_out": sb_out,
        "anc_bit": anc_bit,
        "anc_out": anc_out,
    }


def _emit_impl(
    committed, is_match, litlen_sym, lcode, dcode, mlen, mdist,
    ll_len, ll_code, d_len, d_code, hdr_vals, hdr_nbits, eob_v, eob_nb,
    out_words=None, with_anchors=False, token_slots=0,
):
    """Phase 2: pack the phase-1 token arrays with host-built tables.

    Tables/headers are per sub-block — ll_len etc. are (SB, 288),
    hdr_vals (SB, HDR_SLOTS), eob_v/eob_nb (SB,). The field stream
    interleaves [hdr_b, tokens of sub-block b, EOB_b]; the host merges
    similar adjacent sub-blocks into one deflate block by zeroing the
    interior header/EOB widths (huffman_host.build_chunk_plan).

    token_slots > 0 switches on TOKEN COMPACTION: one full-width scatter
    collects the committed positions into `token_slots` dense slots and
    every remaining emit pass (table gathers, offset cumsum, the
    three-word scatter-pack) runs at token width instead of position
    width. Gather/scatter cost scales with the element count, so halving
    the hot widths halves those passes. Bit-identical to the full-width path
    (the scattered fields are the same values at the same offsets).
    The caller must guarantee ntokens <= token_slots per chunk (the host
    checks sum(freq_ll) before picking this graph); if the guarantee is
    ever violated the chunk's nbits is poisoned to 2^30-ish so the
    stitcher takes its stored fallback instead of a truncated stream.
    """
    n = committed.shape[0]
    sb = ll_len.shape[0]
    bounds = sub_block_bounds(n)
    pos = jnp.arange(n, dtype=jnp.int32)

    if token_slots:
        return _emit_compact(
            committed, is_match, litlen_sym, lcode, dcode, mlen, mdist,
            ll_len, ll_code, d_len, d_code, hdr_vals, hdr_nbits,
            eob_v, eob_nb, out_words, with_anchors, token_slots,
        )

    tb = jnp.zeros((n,), jnp.int32)
    for b in range(1, sb):
        tb = tb + (pos >= bounds[b]).astype(jnp.int32)

    lsym_safe = jnp.clip(litlen_sym, 0, C.NUM_LITLEN_SYMBOLS - 1)
    dsym_safe = jnp.clip(dcode, 0, C.NUM_DIST_SYMBOLS - 1)
    # ONE packed gather per tree (entry = code | len << 20; codes <= 15
    # bits after bit-reversal, lengths <= 15): halving the table lookups
    # and replacing the base/extra table takes with closed-form bit math
    # (_len_extra_base/_dist_extra_base) halves the emit phase's
    # full-width gathers.
    ll_pack = ll_code.astype(jnp.uint32) | (ll_len.astype(jnp.uint32) << 20)
    d_pack = d_code.astype(jnp.uint32) | (d_len.astype(jnp.uint32) << 20)
    e0 = ll_pack[tb, lsym_safe]
    f0_v = e0 & jnp.uint32(0xFFFFF)
    f0_b = jnp.where(committed, (e0 >> 20).astype(jnp.int32), 0)
    e2 = d_pack[tb, dsym_safe]
    f2_v = e2 & jnp.uint32(0xFFFFF)
    f2_b = jnp.where(is_match, (e2 >> 20).astype(jnp.int32), 0)
    lext, lbase = _len_extra_base(lcode)
    f1_v = (mlen - lbase).astype(jnp.uint32)
    f1_b = jnp.where(is_match, lext, 0)
    dext, dbase = _dist_extra_base(dsym_safe)
    f3_v = (mdist - dbase).astype(jnp.uint32)
    f3_b = jnp.where(is_match, dext, 0)

    # Merge each position's four fields into ONE <= 48-bit field (lo u32 +
    # hi 16 bits) with a closed-form absolute bit offset: one cumsum, one
    # three-word scatter — instead of materializing an interleaved
    # [hdr, tokens, eob] stream (the stacks + 4N cumsum+scatter were the
    # emit phase's dominant device cost before).
    def _mask(v, b):
        return v.astype(jnp.uint32) & (
            (jnp.uint32(1) << b.astype(jnp.uint32)) - 1
        )

    f0m = _mask(f0_v, f0_b)
    f1m = _mask(f1_v, f1_b)
    f2m = _mask(f2_v, f2_b)
    f3m = _mask(f3_v, f3_b)
    m0_v = f0m | (f1m << f0_b.astype(jnp.uint32))
    m0_b = f0_b + f1_b
    m1_v = f2m | (f3m << f2_b.astype(jnp.uint32))
    m1_b = f2_b + f3_b
    m0u = m0_b.astype(jnp.uint32)
    lo48 = m0_v | (m1_v << m0u)
    hi48 = (m1_v >> (jnp.uint32(31) - m0u)) >> jnp.uint32(1)

    tw = (m0_b + m1_b).astype(jnp.int32)
    cum = jnp.cumsum(tw)
    excl = cum - tw
    hdr_tot = jnp.sum(hdr_nbits, axis=1).astype(jnp.int32)  # (SB,)
    eob_b32 = eob_nb.astype(jnp.int32)
    # Per-sub-block: token-bit prefix S_b at its first position, token
    # total T_b, and the stream layout [hdr_b, tokens_b, eob_b]...
    S = jnp.stack([excl[bounds[b]] for b in range(sb)])
    T = jnp.stack(
        [cum[bounds[b + 1] - 1] - S[b] for b in range(sb)]
    )
    seg = hdr_tot + T + eob_b32
    hdr_base = jnp.cumsum(seg) - seg  # (SB,) hdr start offsets
    total_bits = hdr_base[sb - 1] + seg[sb - 1]
    sb_bits = hdr_base

    # Token offset: hdr_base[tb] + hdr_tot[tb] + (excl - S[tb]); the
    # per-sub-block constant is applied with a static where-cascade
    # (sb <= 4) rather than a gather.
    add = jnp.zeros((), jnp.int32)
    for b in range(sb):
        const_b = hdr_base[b] + hdr_tot[b] - S[b]
        add = jnp.where(pos >= bounds[b], const_b, add)
    off0 = excl + add

    words = jnp.zeros((out_words,), jnp.uint32)
    words = bitpack.scatter_field48(words, off0, lo48, hi48, tw, out_words)

    # Headers + EOBs: ~SB * (HDR_SLOTS + 1) small fields.
    hdr_off = (
        jnp.cumsum(hdr_nbits, axis=1) - hdr_nbits + hdr_base[:, None]
    )
    eob_off = hdr_base + hdr_tot + T
    words = bitpack.scatter_fields(
        words, hdr_off.reshape(-1), hdr_vals.reshape(-1).astype(jnp.uint32),
        hdr_nbits.reshape(-1), out_words,
    )
    words = bitpack.scatter_fields(
        words, eob_off, eob_v.astype(jnp.uint32), eob_b32, out_words
    )
    # True OUTPUT offset of each sub-block's first token: matches may
    # cross sub-block boundaries (a token belongs to the block where it
    # STARTS), so the output split points are the cumulative outlens at
    # the token-range bounds — not multiples of the sub-block size.
    outlen = jnp.where(
        is_match, mlen, jnp.where(committed, 1, 0)
    ).astype(jnp.int32)
    out_excl = jnp.cumsum(outlen) - outlen
    sb_out = jnp.stack([out_excl[bounds[b]] for b in range(sb)])

    # v3 index anchors: the (bit, output) position of every
    # ANCHOR_TOKENS-th committed token WITHIN its sub-block, so the
    # device decoder's per-lane token walk has a static step bound. Slots are
    # -1 when a sub-block has fewer tokens (the host keeps valid ones).
    # Skipped (two full-width scatters + a cumsum) unless the caller is
    # building an indexed stream.
    a_total = sb * _A_PB
    if with_anchors:
        ctok = jnp.cumsum(committed.astype(jnp.int32)) - committed
        csub = jnp.zeros((), jnp.int32)
        for b in range(sb):
            csub = jnp.where(pos >= bounds[b], ctok[bounds[b]], csub)
        o_b = ctok - csub
        t_anchor = C.ANCHOR_TOKENS
        is_anchor = committed & (o_b > 0) & (o_b % t_anchor == 0)
        slot = jnp.where(
            is_anchor, tb * _A_PB + (o_b // t_anchor - 1), a_total
        )
        anc_bit = jnp.full((a_total,), -1, jnp.int32).at[slot].set(
            off0, mode="drop"
        )
        anc_out = jnp.full((a_total,), -1, jnp.int32).at[slot].set(
            out_excl, mode="drop"
        )
    else:
        anc_bit = jnp.full((a_total,), -1, jnp.int32)
        anc_out = jnp.full((a_total,), -1, jnp.int32)
    return {
        "words": words,
        "nbits": total_bits,
        "ntokens": jnp.sum(committed.astype(jnp.int32)),
        "sb_bits": sb_bits,  # bit offset of each sub-block's first field
        "sb_out": sb_out,    # output offset of each sub-block's tokens
        "anc_bit": anc_bit,  # v3 anchors: token bit offsets (-1 = unused)
        "anc_out": anc_out,  # v3 anchors: token output offsets
    }


@functools.partial(
    jax.jit,
    static_argnames=("out_words", "with_anchors", "compact", "token_slots"),
)
def emit_chunks_batch(
    analysis, out_words,
    ll_len, ll_code, d_len, d_code, hdr_vals, hdr_nbits, eob_v, eob_nb,
    keep_bits_max=None, with_anchors=False, compact=False, token_slots=0,
):
    """Phase 2, batched: consumes the phase-1 output dict directly.

    compact=True additionally concatenates every chunk's USED words
    (ceil((nbits+3)/32); +3 covers the sync-flush opener bits the
    stitcher reads) into one dense "flat_words" buffer with per-chunk
    "word_cnt". The host then fetches exactly the compressed bytes
    instead of a (B, batch-max) padded slice (the padded buffers are
    ~2.5x the compressed size).

    keep_bits_max (B,) int32, compact mode only: chunks whose nbits
    exceed it get word_cnt=0 and contribute nothing to flat_words — the
    host stitcher will take the stored-block fallback for them anyway
    (incompressible chunks' Huffman coding is LARGER than the raw bytes;
    fetching it would waste the scarce device->host bandwidth). The
    threshold is computed host-side to replicate the stitcher's
    stored-vs-huffman byte comparison exactly."""
    fn = functools.partial(
        _emit_impl, out_words=out_words, with_anchors=with_anchors,
        token_slots=token_slots,
    )
    out = jax.vmap(fn)(
        analysis["committed"], analysis["is_match"], analysis["litlen_sym"],
        analysis["lcode"], analysis["dcode"], analysis["mlen"],
        analysis["mdist"],
        ll_len, ll_code, d_len, d_code, hdr_vals, hdr_nbits, eob_v, eob_nb,
    )
    if compact:
        words = out["words"]                      # (B, W) u32
        bsz, w = words.shape
        cnt = (out["nbits"] + 3 + 31) // 32       # (B,) used words
        if keep_bits_max is not None:
            cnt = jnp.where(out["nbits"] <= keep_bits_max, cnt, 0)
        off = jnp.cumsum(cnt) - cnt               # exclusive prefix
        k = jnp.arange(w, dtype=jnp.int32)[None, :]
        tgt = jnp.where(k < cnt[:, None], off[:, None] + k, bsz * w)
        flat = jnp.zeros((bsz * w,), jnp.uint32).at[tgt.reshape(-1)].set(
            words.reshape(-1), mode="drop"
        )
        out["flat_words"] = flat
        out["word_cnt"] = cnt
        del out["words"]  # don't keep (or fetch) the padded buffers
    # One packed int32 buffer covering every small per-batch output, so
    # the host pays ONE fetch roundtrip instead of five. Layout along
    # axis 1: [nbits | sb_bits | sb_out | anc_bit | anc_out].
    out["meta"] = jnp.concatenate(
        [
            out["nbits"][:, None], out["sb_bits"], out["sb_out"],
            out["anc_bit"], out["anc_out"],
        ],
        axis=1,
    ).astype(jnp.int32)
    return out


@functools.partial(
    jax.jit,
    static_argnames=(
        "params", "out_words", "huffman_only", "fixed_only", "with_checksums"
    ),
)
def encode_chunks_batch(
    data: jax.Array,
    starts: jax.Array,
    valid_ends: jax.Array,
    window_starts: jax.Array,
    bfinals: jax.Array,
    params: LevelParams,
    out_words: int,
    huffman_only: bool = False,
    fixed_only: bool = False,
    with_checksums: bool = False,
):
    """Batched encoder: data is (B, N) uint8, scalars become (B,) arrays.

    Chunks in the batch are fully independent (the data-parallel axis of
    SURVEY.md section 2.1); sharding the leading axis over a device mesh
    turns this single jitted call into the multi-chip encode step.

    with_checksums=True additionally returns per-chunk "adler" and "crc"
    partials over [start, valid_end) — the host merges them in order with
    ops.checksums.{adler32,crc32}_combine (SURVEY.md C3/C4 shard design),
    so container trailers never re-touch the input bytes on the host.
    """
    fn = functools.partial(
        _encode_impl,
        params=params,
        out_words=out_words,
        huffman_only=huffman_only,
        fixed_only=fixed_only,
    )
    out = jax.vmap(fn)(data, starts, valid_ends, window_starts, bfinals)
    if with_checksums:
        from zzflate_tpu.ops import checksums as cs

        out["adler"] = jax.vmap(
            lambda d, s, e: cs._adler32_impl(d, e, s)
        )(data, starts, valid_ends)
        out["crc"] = jax.vmap(
            lambda d, s, e: cs._crc32_impl(d, e, s)
        )(data, starts, valid_ends)
    return out


def output_words_bound(chunk_bytes: int) -> int:
    """u32 buffer size: fixed-tree worst case < 9.4 bits/byte + headers
    (one dynamic header per sub-block, <= ~8 Kbit each)."""
    return (chunk_bytes * 10 + 65536 + sub_block_count(chunk_bytes) * 8192) // 32
