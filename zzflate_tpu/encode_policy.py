"""Stitching & parse policy for the batched encode pipeline.

Split out of api._encode_segments (round-4 verdict item 6): this module
owns the POLICY decisions — when the stored fallback beats the Huffman
segment, the device-side keep_bits_max budget that mirrors it, how a
finished chunk becomes a framed segment with its block/anchor index
rows, and the level 7-9 optimal-parse override. The queue/dispatch
MECHANISM lives in encode_pipeline.py.

Reference contract: the stored-vs-dynamic block choice is SURVEY.md C13
(zlib picks stored for incompressible data, observed [V]); sync-flush
framing per chunk is the SURVEY.md section 3.2 / 5.7 chunk-join scheme.
"""
from __future__ import annotations

import numpy as np

from zzflate_tpu.utils import containers

_WINDOW = 32768


def host_keep(ctx, i: int, nbits: int) -> bool:
    """Host replica of the stored-vs-huffman choice (and of the device
    keep_bits_max threshold): True when the Huffman segment is worth
    fetching/using, False when the stored fallback wins."""
    if not ctx.frame:
        return True
    clen = min(ctx.chunk_bytes, max(0, ctx.n - i * ctx.chunk_bytes))
    stored_len = 5 * max(1, -(-clen // 65535)) + clen
    if (i == ctx.nchunks - 1) and ctx.stream_final:
        return (nbits + 7) // 8 <= stored_len
    return (nbits + 10) // 8 + 4 <= stored_len


def keep_bits_budget(ctx, b0: int, b1: int) -> np.ndarray | None:
    """Per-chunk bit budget above which the stitcher picks the stored
    fallback: don't fetch Huffman words it will discard. Mirrors
    assemble_chunk's byte comparison: non-final segments cost
    ceil((nbits+3)/8)+4 bytes (sync-flush opener + marker), final ones
    ceil(nbits/8); stored costs 5*ceil(L/65535)+L."""
    if not (ctx.compact and ctx.frame):
        return None
    kbm = np.full((ctx.bsz,), np.iinfo(np.int32).max, np.int32)
    for j in range(b1 - b0):
        i = b0 + j
        clen = min(ctx.chunk_bytes, max(0, ctx.n - i * ctx.chunk_bytes))
        stored_len = 5 * max(1, -(-clen // 65535)) + clen
        if (i == ctx.nchunks - 1) and ctx.stream_final:
            kbm[j] = 8 * stored_len
        else:
            kbm[j] = 8 * (stored_len - 4) - 3
    return kbm


def assemble_chunk(ctx, i: int, nbits: int, words_np, keep: bool):
    """One chunk's framed segment bytes (or unframed (bytes, nbits))."""
    final = (i == ctx.nchunks - 1) and ctx.stream_final
    if not ctx.frame:
        return (words_np.tobytes()[: (nbits + 7) // 8], nbits)
    if not keep:
        # The stored fallback wins; the Huffman words were never fetched
        # (keep_bits_budget zeroed word_cnt on device / the padded fetch
        # width excluded this chunk).
        chunk = ctx.data[i * ctx.chunk_bytes : (i + 1) * ctx.chunk_bytes]
        return containers.stored_segment(chunk, final=final)
    if final:
        return words_np.tobytes()[: (nbits + 7) // 8]
    # +3 zero bits open the sync-flush empty stored block; its alignment
    # padding is zeros too (buffer starts zeroed).
    return (
        words_np.tobytes()[: (nbits + 3 + 7) // 8]
        + containers.SYNC_FLUSH_MARKER
    )


def index_rows(plan, sb_bits_row, sb_out_row, anc_bit_row, anc_out_row):
    """Block/anchor index entries for one kept chunk.

    Blocks: (bit offset in segment, output offset in chunk) per
    block-group start. Anchors: interior sub-blocks of merged groups
    (their first field IS their first token — interior headers are
    zero-width) plus the emit phase's every-ANCHOR_TOKENS slots."""
    blocks = [
        (int(sb_bits_row[g[0]]), int(sb_out_row[g[0]]))
        for g in plan["groups"]
    ]
    anc = [
        (int(sb_bits_row[b]), int(sb_out_row[b]))
        for g in plan["groups"]
        for b in g[1:]
    ]
    valid = anc_bit_row >= 0
    anc += [
        (int(bb), int(oo))
        for bb, oo in zip(anc_bit_row[valid], anc_out_row[valid])
    ]
    anc.sort()
    return blocks, anc


def optimal_override(ctx, plans, ana, bfinals, b0: int, b1: int):
    """Level 7-9: replace the device lazy parse with the native C
    shortest-bit-path DP priced by the pass-1 trees, then rebuild the
    tables from the DP's own token histogram (2-iteration cost model;
    SURVEY.md C7 / Appendix B chain-4096 effort analogue).

    Mutates `plans` in place; returns (override_dict | None, ntok_max).
    """
    from zzflate_tpu import constants as C_
    from zzflate_tpu import native as _native
    from zzflate_tpu.models import deflate_encoder
    from zzflate_tpu.ops import huffman_host

    bsz = ctx.bsz
    buf = ana["_host_buf"]
    vends = ana["_host_valid_ends"]
    mm = np.asarray(ana["mm_packed"])  # one half-size fetch
    mlen_np = mm >> 16
    mdist_np = mm & 0xFFFF
    nn = buf.shape[1]
    bounds = deflate_encoder.sub_block_bounds(nn)
    sbn = len(bounds) - 1
    com_b = np.zeros((bsz, nn), bool)
    take_b = np.zeros((bsz, nn), bool)
    sel_b = np.zeros((bsz, nn), np.int32)
    sym_b = np.zeros((bsz, nn), np.int32)
    lcode_b = np.zeros((bsz, nn), np.int32)
    dcode_np = np.maximum(
        np.searchsorted(
            np.asarray(C_.DIST_BASE),
            np.maximum(mdist_np, 1),
            side="right",
        ).astype(np.int32)
        - 1,
        0,
    )
    ltc = np.asarray(C_.LENGTH_TO_CODE)
    for j in range(bsz):
        res = _native.optimal_parse(
            buf[j], mlen_np[j], mdist_np[j], _WINDOW,
            int(vends[j]), plans[j]["ll_len"],
            plans[j]["d_len"], bounds,
        )
        if res is None:
            return None, 0  # library vanished: keep the lazy parse
        com, take, sel = res
        com_b[j], take_b[j], sel_b[j] = com, take, sel
        lc = ltc[np.clip(sel, 0, 258)]
        lcode_b[j] = lc
        sym_b[j] = np.where(take, 257 + lc, buf[j].astype(np.int32))
        fll = np.zeros((sbn, 288), np.int64)
        fd = np.zeros((sbn, 30), np.int64)
        for b in range(sbn):
            s, e = bounds[b], bounds[b + 1]
            m = com[s:e]
            fll[b] = np.bincount(sym_b[j, s:e][m], minlength=288)
            fd[b] = np.bincount(
                dcode_np[j, s:e][take[s:e]], minlength=30
            )
        plans[j] = huffman_host.build_chunk_plan(
            fll, fd,
            bfinal=int(bfinals[j]) if b0 + j < b1 else 0,
            fixed_only=ctx.fixed_only,
            force_single=ctx.single_block_chunks,
        )

    override = {
        "committed": ctx.put(com_b),
        "is_match": ctx.put(take_b),
        "litlen_sym": ctx.put(sym_b),
        "lcode": ctx.put(lcode_b),
        "mlen": ctx.put(sel_b),
        "dcode": ana["dcode"],
        "mdist": ana["mdist"],
    }
    return override, int(com_b.sum(axis=1).max())
