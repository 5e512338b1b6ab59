"""Batched two-phase encode pipeline (the MECHANISM).

Split out of api._encode_segments (round-4 verdict item 6). This module
owns batch staging, the analyze -> plan -> emit -> finish queue pipeline
and the device<->host transfer discipline; the stitching/parse POLICY
(stored-fallback thresholds, framing, optimal-parse override) lives in
encode_policy.py.

Pipeline shape (SURVEY.md section 3.5 encode stack): device analyze
(histograms) for every batch, host Huffman/header build, device emit
(re-tokenize + bit-pack), host stitch in order. Analysis for batch i+1
is in flight on device while batch i's tables are built and its emit
graph queued, and while batch i-1's output words are fetched — peak
device memory is a constant number of batches regardless of input size
(BASELINE.json:11 GB-scale requirement).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from zzflate_tpu import config as cfg_mod
from zzflate_tpu import encode_policy as policy
from zzflate_tpu.models import deflate_encoder

_WINDOW = 32768

# Compact the emit phase's per-chunk word buffers into one dense device
# buffer before fetching (exact-size transfer; see emit_chunks_batch):
# one extra device scatter pass in exchange for fetching only the used
# words (ZZFLATE_COMPACT_FETCH=0 opts out).
_COMPACT = os.environ.get("ZZFLATE_COMPACT_FETCH", "1") == "1"


def _compact_tokens_enabled() -> bool:
    """Token-compacted emit graph (deflate_encoder._emit_compact): every
    emit pass after one full-width scatter runs at token width (~half).
    Host gating routes batches whose token counts exceed the static
    budget to the full-width graph instead. ZZFLATE_COMPACT_TOKENS=0
    opts out (read per call so A/B runs flip it without reimporting)."""
    return os.environ.get("ZZFLATE_COMPACT_TOKENS", "1") == "1"


@dataclass
class _Ctx:
    """Everything one encode run's stages share (read-only after init)."""

    data: bytes
    config: object
    dictionary: bytes | None
    stream_final: bool
    mesh: object
    with_checksums: bool
    single_block_chunks: bool
    frame: bool
    with_anchors: bool
    halo: bool
    # derived
    chunk_bytes: int = 0
    out_words: int = 0
    params: object = None
    huffman_only: bool = False
    fixed_only: bool = False
    n: int = 0
    nchunks: int = 0
    bsz: int = 0
    ndev: int = 1
    sharding: object = None
    max_dist: int = 32768
    optimal: bool = False
    compact: bool = False
    results: dict = field(default_factory=dict)

    def put(self, a: np.ndarray):
        """Host rows to the device, or each device's rows to it on a mesh."""
        import jax
        import jax.numpy as jnp

        if self.sharding is not None:
            return jax.device_put(a, self.sharding)
        return jnp.asarray(a)


def _device_batch(chunk_bytes: int, mem_level: int = 8) -> int:
    """Chunks dispatched per device call, sized to bound peak HBM.

    ~4 MiB of chunk data per dispatch at the default mem_level=8: the
    suffix-sort matcher holds ~15 int32 arrays per position (~70 MiB per
    MiB-of-input transient, ~0.6 GiB peak with the 2-batch pipeline)
    and larger dispatches amortize the per-dispatch overhead. mem_level
    (zlib.h:581-585 contract) scales the budget: each level below 8
    halves it, 9 doubles it."""
    shift = mem_level - 8
    base = int(os.environ.get("ZZFLATE_BATCH_MIB", "4")) << 20
    budget = base << shift if shift >= 0 else base >> -shift
    return max(1, min(64, budget // chunk_bytes))


def build_chunk_batch(
    data: bytes,
    chunk_bytes: int,
    dictionary: bytes | None,
    mark_final: bool = True,
    halo: bool = True,
):
    """Lay out (nchunks, 32K + chunk_bytes) rows with halo prefixes.

    Chunk i's prefix is chunk i-1's last 32 KiB (the sequence-parallel
    halo of SURVEY.md section 5.7); chunk 0's is the preset dictionary.
    halo=False leaves every prefix empty (window reset per chunk — the
    seekable/random-access layout, Z_FULL_FLUSH semantics per chunk).
    Returns (buf, valid_ends, window_starts, bfinals, nchunks).
    """
    n = len(data)
    nchunks = max(1, -(-n // chunk_bytes))
    buf = np.zeros((nchunks, _WINDOW + chunk_bytes), dtype=np.uint8)
    valid_ends = np.zeros((nchunks,), dtype=np.int32)
    window_starts = np.zeros((nchunks,), dtype=np.int32)
    bfinals = np.zeros((nchunks,), dtype=np.int32)
    for i in range(nchunks):
        chunk = data[i * chunk_bytes : (i + 1) * chunk_bytes]
        if not halo:
            prefix = b""
        elif i == 0:
            prefix = (dictionary or b"")[-_WINDOW:]
        else:
            prefix = data[max(0, i * chunk_bytes - _WINDOW) : i * chunk_bytes]
        if prefix:
            buf[i, _WINDOW - len(prefix) : _WINDOW] = np.frombuffer(
                prefix, np.uint8
            )
        if chunk:
            buf[i, _WINDOW : _WINDOW + len(chunk)] = np.frombuffer(
                chunk, np.uint8
            )
        valid_ends[i] = _WINDOW + len(chunk)
        window_starts[i] = _WINDOW - len(prefix)
    if mark_final:
        bfinals[nchunks - 1] = 1
    return buf, valid_ends, window_starts, bfinals, nchunks


def _make_ctx(data, config, dictionary, stream_final, mesh, with_checksums,
              single_block_chunks, frame, with_anchors, halo) -> _Ctx:
    ctx = _Ctx(
        data=data, config=config, dictionary=dictionary,
        stream_final=stream_final, mesh=mesh,
        with_checksums=with_checksums,
        single_block_chunks=single_block_chunks, frame=frame,
        with_anchors=with_anchors, halo=halo,
    )
    ctx.chunk_bytes = config.chunk_bytes
    ctx.out_words = deflate_encoder.output_words_bound(ctx.chunk_bytes)
    ctx.params = config.params
    ctx.huffman_only = config.strategy == cfg_mod.STRATEGY_HUFFMAN_ONLY
    ctx.fixed_only = config.strategy == cfg_mod.STRATEGY_FIXED
    ctx.n = len(data)
    ctx.nchunks = max(1, -(-ctx.n // ctx.chunk_bytes))

    bsz = _device_batch(ctx.chunk_bytes, config.mem_level)
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec

        ctx.ndev = mesh.devices.size
        bsz = ctx.ndev * max(1, bsz)
        ctx.sharding = NamedSharding(mesh, PartitionSpec(mesh.axis_names[0]))
    # Never batch far beyond the real chunk count: padded rows run the
    # FULL analyze/emit compute for nothing (a 2 MiB input on a 4-device
    # mesh would otherwise dispatch 256 rows for 32 real chunks). Pow2
    # bucketing of the per-device row count keeps the number of compiled
    # shapes logarithmic while bounding pad waste at <2x.
    per_dev = -(-ctx.nchunks // ctx.ndev)
    cap = 1 << max(0, per_dev - 1).bit_length()
    ctx.bsz = max(ctx.ndev, min(bsz, cap * ctx.ndev))
    ctx.max_dist = min(32768, 1 << config.window_bits)

    # Level-9 cost-aware parse: native C shortest-bit-path DP over the
    # device matcher's (mlen, mdist) replaces the lazy commit.
    from zzflate_tpu import native as _native

    ctx.optimal = (
        ctx.params.optimal and not ctx.huffman_only
        and _native.lib() is not None
    )
    # Cross-chunk fetch compaction would force cross-device traffic on a
    # mesh; only compact the single-device path.
    ctx.compact = _COMPACT and ctx.sharding is None
    return ctx


def _dispatch_analyze(ctx: _Ctx, b0: int):
    """Stage host rows for chunks [b0, b0+bsz) and queue analysis."""
    from zzflate_tpu.utils.profiling import maybe_stage

    b1 = min(b0 + ctx.bsz, ctx.nchunks)
    cb = ctx.chunk_bytes
    with maybe_stage("build_batches"):
        buf, valid_ends, window_starts, bfinals, _ = build_chunk_batch(
            ctx.data[b0 * cb : b1 * cb], cb,
            ctx.dictionary if b0 == 0
            else ctx.data[max(0, b0 * cb - _WINDOW) : b0 * cb],
            mark_final=ctx.stream_final and b1 == ctx.nchunks,
            halo=ctx.halo,
        )
        pad = ctx.bsz - (b1 - b0)
        if pad:
            # Pad the tail batch to the fixed batch size (one compiled
            # graph); padded rows encode an empty block the stitcher
            # ignores.
            buf = np.concatenate(
                [buf, np.zeros((pad,) + buf.shape[1:], buf.dtype)]
            )
            valid_ends = np.concatenate(
                [valid_ends, np.full((pad,), _WINDOW, np.int32)]
            )
            window_starts = np.concatenate(
                [window_starts, np.full((pad,), _WINDOW, np.int32)]
            )
        starts = np.full((ctx.bsz,), _WINDOW, dtype=np.int32)
        db = (ctx.put(buf), ctx.put(starts), ctx.put(valid_ends),
              ctx.put(window_starts))
    with maybe_stage("analyze_dispatch"):
        ana = deflate_encoder.analyze_chunks_batch(
            *db, ctx.params, huffman_only=ctx.huffman_only,
            with_checksums=ctx.with_checksums,
            strategy=ctx.config.strategy, max_dist=ctx.max_dist,
        )
    if ctx.optimal:
        ana = dict(ana, _host_buf=buf, _host_valid_ends=valid_ends)
    return (b0, b1), bfinals, ana


def _plan_and_emit(ctx: _Ctx, sl, bfinals, ana):
    """Fetch tiny freqs, build tables on host, queue the emit graph.

    Drops every big per-position analysis array afterwards so device
    memory stays bounded by the pipeline window, not the input."""
    from zzflate_tpu.ops import huffman_host
    from zzflate_tpu.utils.profiling import maybe_stage

    b0, b1 = sl
    with maybe_stage("analyze_fetch_freqs"):
        # One packed fetch (one roundtrip) for both tables.
        freqs = np.asarray(ana["freqs"])  # (bsz, SB, 288 + 30)
        freq_ll = freqs[..., :288]
        freq_d = freqs[..., 288:]
    with maybe_stage("host_plan"):
        plans = [
            huffman_host.build_chunk_plan(
                freq_ll[j],
                freq_d[j],
                bfinal=int(bfinals[j]) if b0 + j < b1 else 0,
                fixed_only=ctx.fixed_only,
                force_single=ctx.single_block_chunks,
            )
            for j in range(ctx.bsz)
        ]

    override = None
    override_ntok = 0
    if ctx.optimal:
        with maybe_stage("optimal_parse"):
            override, override_ntok = policy.optimal_override(
                ctx, plans, ana, bfinals, b0, b1
            )

    def stack(key, dtype):
        return ctx.put(np.stack([p[key] for p in plans]).astype(dtype))

    kbm = policy.keep_bits_budget(ctx, b0, b1)

    # Pick the token-compacted emit graph when every chunk's committed
    # token count (from the freqs, or the DP's own mask) fits the
    # static budget; barely-LZ-compressible batches take the full-width
    # graph (token_slots=0).
    tok_slots = 0
    if _compact_tokens_enabled():
        budget = deflate_encoder.token_budget(ctx.chunk_bytes)
        ntk = (
            override_ntok if override is not None
            else int(freq_ll.sum(axis=(1, 2)).max())
        )
        if ntk <= budget:
            tok_slots = budget
    with maybe_stage("emit_dispatch"):
        res = deflate_encoder.emit_chunks_batch(
            override
            or {
                k: ana[k]
                for k in (
                    "committed", "is_match", "litlen_sym", "lcode",
                    "dcode", "mlen", "mdist",
                )
            },
            ctx.out_words,
            stack("ll_len", np.int32),
            stack("ll_code", np.uint32),
            stack("d_len", np.int32),
            stack("d_code", np.uint32),
            stack("hdr_vals", np.uint32),
            stack("hdr_nbits", np.int32),
            stack("eob_v", np.uint32),
            stack("eob_nb", np.int32),
            keep_bits_max=None if kbm is None else ctx.put(np.asarray(kbm)),
            with_anchors=ctx.with_anchors,
            compact=ctx.compact,
            token_slots=tok_slots,
        )
    cks = ana["cks"] if ctx.with_checksums else None
    return sl, plans, res, cks, kbm


def _finish(ctx: _Ctx, sl, plans, res, cks, kbm):
    """Fetch the finished batch and assemble its segments in order."""
    from zzflate_tpu.utils.profiling import maybe_stage

    out = ctx.results
    b0, b1 = sl
    # Fetch the packed metadata first (ONE roundtrip: bit counts,
    # sub-block offsets, anchors), then only the used prefix of the
    # word buffers (device->host bandwidth is the scarce resource;
    # the padded buffers are ~2.5x the compressed size).
    with maybe_stage("emit_fetch"):
        sbw = res["sb_bits"].shape[1]
        aw = res["anc_bit"].shape[1]
        meta = np.asarray(res["meta"])
        nbits_np = meta[:, 0]
        sb_bits_np = meta[:, 1 : 1 + sbw]
        sb_out_np = meta[:, 1 + sbw : 1 + 2 * sbw]
        anc_bit_np = meta[:, 1 + 2 * sbw : 1 + 2 * sbw + aw]
        anc_out_np = meta[:, 1 + 2 * sbw + aw :]
        keep = [
            policy.host_keep(ctx, b0 + j, int(nbits_np[j]))
            for j in range(b1 - b0)
        ]
        if "flat_words" in res:
            # Compacted emit: fetch exactly the used words of the whole
            # batch in one dense transfer. The per-chunk word counts are
            # recomputed from nbits with the same rule the device used
            # (no word_cnt fetch).
            cnt_np = ((nbits_np + 3 + 31) // 32).astype(np.int64)
            if kbm is not None:
                cnt_np = np.where(nbits_np <= kbm, cnt_np, 0)
            w_off = np.concatenate([[0], np.cumsum(cnt_np)])
            flat_np = np.asarray(
                res["flat_words"][: int(w_off[-1])], dtype="<u4"
            )
            chunk_words = [
                flat_np[w_off[j] : w_off[j + 1]]
                for j in range(b1 - b0)
            ]
        else:
            # Width the padded batch fetch to the widest KEPT chunk:
            # stored-bound chunks are exactly the widest rows (their
            # Huffman coding exceeds the raw size) and their words are
            # never used.
            kept_bits = [
                int(nbits_np[j]) for j in range(b1 - b0) if keep[j]
            ]
            max_used = min(
                ctx.out_words,
                int((max(kept_bits, default=0) + 3 + 31) // 32) + 1,
            )
            words_np = np.asarray(
                res["words"][:, :max_used], dtype="<u4"
            )
            chunk_words = [words_np[j] for j in range(b1 - b0)]
    if ctx.with_checksums:
        vals = np.asarray(cks)  # (bsz, 2): one roundtrip
        out["adler"].extend(int(x) for x in vals[: b1 - b0, 0])
        out["crc"].extend(int(x) for x in vals[: b1 - b0, 1])
    for j in range(b1 - b0):
        i = b0 + j
        nbits = int(nbits_np[j])
        seg = policy.assemble_chunk(ctx, i, nbits, chunk_words[j], keep[j])
        out["segments"].append(seg)
        if not ctx.frame or not keep[j]:
            # Unframed segments carry no index; stored fallbacks' block
            # entries are meaningless (the decoder detects BTYPE=0).
            out["blocks"].append([])
            out["anchors"].append([])
            continue
        blocks, anc = policy.index_rows(
            plans[j], sb_bits_np[j], sb_out_np[j],
            anc_bit_np[j], anc_out_np[j],
        )
        out["blocks"].append(blocks)
        out["anchors"].append(anc)


def encode_segments(
    data: bytes,
    config,
    dictionary: bytes | None,
    stream_final: bool = True,
    mesh=None,
    with_checksums: bool = False,
    single_block_chunks: bool = False,
    frame: bool = True,
    with_anchors: bool = False,
    halo: bool = True,
) -> dict:
    """Deflate payload as byte-aligned per-chunk segments (sync-flush
    framed). See api._encode_segments for the public contract.

    frame=False returns UNFRAMED segments as (bytes, nbits) tuples — no
    sync-flush marker, no stored fallback, the last byte possibly
    partial — for callers that join segments at bit granularity (the
    stream layer's Z_BLOCK support).
    """
    ctx = _make_ctx(
        data, config, dictionary, stream_final, mesh, with_checksums,
        single_block_chunks, frame, with_anchors, halo,
    )
    ctx.results = {
        "segments": [], "blocks": [], "anchors": [],
        "adler": [] if with_checksums else None,
        "crc": [] if with_checksums else None,
    }

    # Windowed two-stage pipeline: analysis for batch i+1 is in flight
    # on device while batch i's tables are built and its emit graph
    # queued, and while batch i-1's output words are fetched.
    #
    # _finish runs on ONE worker thread (order-preserving): its blocking
    # device->host fetches release the GIL, so batch i's words transfer
    # while the main thread plans/dispatches batch i+1, instead of a
    # serial fetch tail per batch.
    import collections
    from concurrent.futures import ThreadPoolExecutor

    a_q: collections.deque = collections.deque()
    e_q: collections.deque = collections.deque()
    f_q: collections.deque = collections.deque()
    with ThreadPoolExecutor(max_workers=1) as pool:
        def submit_finish():
            f_q.append(pool.submit(_finish, ctx, *e_q.popleft()))
            # Keep at most 2 finishes in flight so emit outputs don't
            # accumulate on device; .result() re-raises worker errors.
            while len(f_q) > 2:
                f_q.popleft().result()

        for b0 in range(0, ctx.nchunks, ctx.bsz):
            a_q.append(_dispatch_analyze(ctx, b0))
            if len(a_q) >= 2:
                e_q.append(_plan_and_emit(ctx, *a_q.popleft()))
            if len(e_q) >= 2:
                submit_finish()
        while a_q:
            e_q.append(_plan_and_emit(ctx, *a_q.popleft()))
        while e_q:
            submit_finish()
        while f_q:
            f_q.popleft().result()

    return ctx.results
