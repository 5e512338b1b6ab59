"""LZ77 match finding and parse commit, built from data-parallel passes.

The reference-class codec walks per-position hash chains and extends
matches with a sequential memcmp loop (SURVEY.md C5-C7, the dominant ~70%
of encode cycles). Neither maps to a vector machine, so this matcher is
built almost entirely from sorts, rolls and a few strided gathers:

- **Candidate lookup = suffix sort.** One multi-operand `lax.sort` orders
  all positions by their `key_words * 4`-byte prefix (u32 words carried
  through the sort together with the position payload — no post-sort
  gathers). The K elements around a position in sort order are the K
  lexicographically-nearest previous suffixes — a strictly stronger
  candidate set than a hash chain's most-recent-3-byte-prefix list.
  Deeper keys (64 bytes at level >= 6) rank large equal-prefix groups
  exactly, which is what zlib's long chain walks (chain 128..4096,
  SURVEY.md Appendix B) buy on homogeneous data.
- **Exact LCPs from adjacent compares.** The LCP between sort-neighbors
  is the running min of adjacent-element LCPs (ultrametric inequality;
  computed once from the sorted key words with elementwise ops); min over
  a K-window needs K rolls, which XLA fuses into elementwise passes.
- **Long-match extension by block ranks.** Positions whose best neighbor
  shares the full key extend by comparing *dense ranks of key-sized
  blocks* (rank equality <=> exact block equality — no hashing, no
  correctness risk): one (N,) gather per key-width instead of one per
  byte. Rank arrays at 16/32/64-byte granularity all fall out of the one
  sorted order (cumsum of adjacent-LCP thresholds), so the tail refines
  in O(log key) steps.
- **Commit (greedy/lazy parse) = serial row sweeps**: the committed set is
  the orbit of `next[p] = p + (commit ? len : 1)`, walked row by row with
  every row of every chunk as one parallel lane (parse_commit_batch).
"""
from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp

from zzflate_tpu.constants import MAX_MATCH, MIN_MATCH, WINDOW_SIZE

_TOO_FAR = 4096  # reject len-3 matches farther than this (zlib heuristic)

# Interior-suffix candidate propagation (see find_matches). Measured
# (2026-08-18, CPU — sizes are platform-independent): silesia-2MiB L1
# 0.9505 -> 0.9483, L6 0.9989 -> 0.9981; zlib.h x6 L6 1.0027 -> 1.0004
# vs zlib at the same level; L9 a wash (optimal parse already covers it).
# Cost: log2(258) = 9 elementwise roll+max passes, no gathers.
_PROPAGATE = os.environ.get("ZZFLATE_PROP", "1") == "1"


def _pack_words(data: jax.Array, nwords: int) -> list[jax.Array]:
    """w[j][i] = BIG-endian u32 of bytes data[i+4j : i+4j+4].

    Big-endian (byte 0 in the high bits) so that unsigned u32 comparison
    equals byte-lexicographic order — the sorted orders below are then true
    lexicographic suffix orders, maximizing neighbor candidate quality.

    Built from ONE shifted-word base: pad data once, make the u32-at-
    every-byte array with 4 static slices, then every deeper word is a
    static slice of that base, so the word views fuse into their
    consumers instead of costing one pass per rolled copy."""
    n = data.shape[0]
    pad = jnp.zeros((4 * nwords + 4,), data.dtype)
    d = jnp.concatenate([data, pad]).astype(jnp.uint32)
    m = n + 4 * nwords
    base = (
        (jax.lax.slice(d, (0,), (m,)) << 24)
        | (jax.lax.slice(d, (1,), (m + 1,)) << 16)
        | (jax.lax.slice(d, (2,), (m + 2,)) << 8)
        | jax.lax.slice(d, (3,), (m + 3,))
    )
    return [
        jax.lax.slice(base, (4 * j,), (4 * j + n,)) for j in range(nwords)
    ]


def _word_lcp_bytes(x: jax.Array) -> jax.Array:
    """Leading equal bytes (0..4) of two u32s given their XOR (BE order)."""
    x = x.astype(jnp.uint32)
    b0 = (x & jnp.uint32(0xFF000000)) == 0
    b1 = b0 & ((x & jnp.uint32(0xFF0000)) == 0)
    b2 = b1 & ((x & jnp.uint32(0xFF00)) == 0)
    b3 = b2 & ((x & jnp.uint32(0xFF)) == 0)
    return (
        b0.astype(jnp.int32)
        + b1.astype(jnp.int32)
        + b2.astype(jnp.int32)
        + b3.astype(jnp.int32)
    )


def _merge(best_pack, s_len, s_dist, spos, n):
    """Scatter sort-space results to position order and fold into bests.

    Candidates are PACKED as len<<15 | (32768 - dist) so one scatter and
    one elementwise max give exactly the (max length, then min distance)
    preference the reference's chain walk has — halving the full-width
    scatters the two-array formulation needed."""
    pack = jnp.where(
        s_len > 0,
        (s_len << 15) | (jnp.int32(WINDOW_SIZE) - s_dist),
        0,
    )
    # spos is a permutation of positions: every index is distinct, and
    # unique_indices lets XLA skip the conflict-handling scatter path.
    p = jnp.zeros((n,), jnp.int32).at[spos].set(
        pack, unique_indices=True
    )
    return jnp.maximum(best_pack, p)


def _unpack_best(best_pack):
    """(mlen, mdist) from the packed best; 0 length -> 0 distance."""
    mlen = best_pack >> 15
    mdist = jnp.int32(WINDOW_SIZE) - (best_pack & (WINDOW_SIZE - 1))
    mdist = jnp.where(mlen > 0, mdist, 0)
    return mlen, mdist


def _lcp_words(aw: list[jax.Array], bw: list[jax.Array]) -> jax.Array:
    """Byte LCP (0..4*len(aw)) of two keys given as u32 word lists."""
    lcp = None
    all_eq = None
    for a, b in zip(aw, bw):
        l = _word_lcp_bytes(a ^ b)
        if lcp is None:
            lcp, all_eq = l, l == 4
        else:
            lcp = lcp + jnp.where(all_eq, l, 0)
            all_eq = all_eq & (l == 4)
    return lcp


def _scan_order(sw, spos, srank, window_start, best_pack,
                k_each, lcp_cap, n, backward_only=False):
    """Score K neighbors (both directions) of one sorted suffix order.

    A previous occurrence with a long common prefix may sit on either
    side in sort order, so scan both ways. LCP(i, i±k) is the running
    min of adjacent LCPs (valid in any order by the ultrametric
    inequality) — all rolls, no gathers. Returns the merged packed
    per-position bests plus this order's adjacent-LCP array (sort space).
    """
    adj = _lcp_words([jnp.roll(v, 1) for v in sw], sw)
    adj = adj.at[0].set(0)

    s_len = jnp.zeros((n,), jnp.int32)
    s_dist = jnp.zeros((n,), jnp.int32)

    def consider(s_len, s_dist, ln_ok, dist, ok):
        ln = jnp.where(ok, ln_ok, 0)
        better = (ln > s_len) | (
            (ln == s_len) & (ln > 0) & (dist < s_dist)
        )
        better = better & ok
        return (
            jnp.where(better, ln, s_len),
            jnp.where(better, dist, s_dist),
        )

    back_min = jnp.full((n,), lcp_cap, jnp.int32)
    fwd_min = jnp.full((n,), lcp_cap, jnp.int32)
    for k in range(1, k_each + 1):
        back_min = jnp.minimum(back_min, jnp.roll(adj, k - 1))
        cpos = jnp.roll(spos, k)
        dist = spos - cpos
        ok = (
            (srank >= k)
            & (dist >= 1)
            & (dist <= WINDOW_SIZE)
            & (cpos >= window_start)
        )
        s_len, s_dist = consider(s_len, s_dist, back_min, dist, ok)

        if backward_only:
            continue
        fwd_min = jnp.minimum(fwd_min, jnp.roll(adj, -k))
        cpos = jnp.roll(spos, -k)
        dist = spos - cpos
        ok = (
            (srank < n - k)
            & (dist >= 1)
            & (dist <= WINDOW_SIZE)
            & (cpos >= window_start)
        )
        s_len, s_dist = consider(s_len, s_dist, fwd_min, dist, ok)

    return _merge(best_pack, s_len, s_dist, spos, n), adj


@functools.partial(jax.jit, static_argnames=("candidates", "key_words"))
def find_matches(
    data: jax.Array,
    valid_end: jax.Array,
    window_start: jax.Array,
    candidates: int,
    key_words: int = 4,
):
    """Best match per position.

    Args:
      data: (N,) uint8, zero-padded beyond valid_end.
      valid_end: scalar int32; bytes at [0, valid_end) are real.
      window_start: scalar int32; match sources must be >= this (bytes
        before it are padding, not part of the decoder's window).
      candidates: static K, number of nearest previous suffixes scored.
      key_words: static suffix-sort key depth in u32 words (the sort is a
        true lexicographic suffix order to 4*key_words bytes).

    Returns:
      (mlen, mdist): int32 (N,) arrays; mlen is 0 or in [3, 258].
    """
    n = data.shape[0]
    pos = jnp.arange(n, dtype=jnp.int32)
    key_bytes = 4 * key_words
    # The extension ladder below strides by key_bytes blocks (rank
    # equality at key_bytes granularity <=> exact block equality) and the
    # tail refines by direct 16-byte word compares (key_bytes // 16
    # rounds) — exact for ANY key_bytes multiple of 16. (The former
    # 16*2^k restriction guarded a 16/32/.. rank ladder that no longer
    # exists.) 48-byte keys would cut the dominant sort from 17 to 13
    # operands, but measured ratio (2026-08-21, CPU, stride 32): w12
    # zlibh_rep 1.0024 / silesia2 0.9994 vs w16's 1.0007 / 0.9985 — the
    # 48-byte scan cap hurts positions that cannot anchor-propagate, so
    # L6+ stays at key_words=16.
    if key_bytes >= 16 and key_bytes % 16:
        raise ValueError(f"key_words*4 must be a multiple of 16, got {key_bytes}")
    w = _pack_words(data, key_words)
    srank = jnp.arange(n, dtype=jnp.int32)

    best_pack = jnp.zeros((n,), jnp.int32)

    # Order A — by the 4-byte leading word: the stable sort keeps equal
    # groups in position order, so backward neighbors are the MOST RECENT
    # previous occurrences of the same 4-byte prefix — exactly the
    # reference's hash-chain candidate order (SURVEY.md C5), with zero
    # collisions. Backward-only: forward neighbors in this order are
    # almost always FUTURE positions (invalid sources); the rare
    # cross-group candidates are covered by order B's forward scan.
    # The first min(key_words, 4) key words ride along so adjacent LCPs
    # are byte-exact to 16 bytes inside equal-w0 groups.
    # (ZZFLATE_NO_ORDER_A=1 skips this sort: a ratio/speed probe, since
    # sort count is the matcher's main cost knob.)
    if os.environ.get("ZZFLATE_NO_ORDER_A") != "1":
        a_words = min(key_words, 4)
        with jax.named_scope("sort"):
            sortedA = jax.lax.sort(
                tuple(w[:a_words]) + (pos,), num_keys=1, is_stable=True
            )
        best_pack, _ = _scan_order(
            list(sortedA[:a_words]), sortedA[a_words], srank, window_start,
            best_pack, min(candidates, 8), 4 * a_words, n,
            backward_only=True,
        )

    # Order B — the full-depth suffix order: neighbors are the suffixes
    # with the LONGEST common prefixes (what a deep chain walk searches
    # for). All key words + position are carried through one sort.
    with jax.named_scope("sort"):
        sortedB = jax.lax.sort(
            tuple(w) + (pos,), num_keys=key_words, is_stable=True
        )
    swB = list(sortedB[:key_words])
    sposB = sortedB[key_words]
    best_pack, adjB = _scan_order(
        swB, sposB, srank, window_start, best_pack,
        candidates, key_bytes, n,
    )

    mlen, mdist = _unpack_best(best_pack)

    # Dense rank of the FULL key-bytes prefix (equality of rank <=> exact
    # equality of the leading key_bytes bytes), from the ONE sorted
    # order: a new prefix starts exactly where the adjacent LCP drops
    # below key_bytes. (The former 16/32-byte rank ladder — two more
    # full-width cumsum+scatter passes — is replaced by direct strided
    # 16-byte word compares in the tail below: the tail runs at anchor
    # stride, ~1/16th the width of a rank pass.)
    def rank_of(width):
        change = (adjB < width).astype(jnp.int32)
        rs = jnp.cumsum(change)
        # sposB is a permutation: unique-index scatter (cheaper lowering).
        return jnp.zeros((n,), jnp.int32).at[sposB].set(
            rs, unique_indices=True
        )

    rank_key = rank_of(key_bytes)

    full = mlen >= key_bytes

    # The block-rank extension below is ~16 random-gather passes. When
    # the key is deep enough (>= 32 bytes > stride), run it EXACTLY but
    # only at stride anchor positions, then propagate to the rest: for p
    # with anchor a = next multiple of the stride, if both are full-key matches at the SAME distance,
    # then lcp(p) >= key_bytes > a-p means bytes [p, a) match, so
    # mlen[p] = (a-p) + mlen[a] exactly (never an overestimate; positions
    # whose distance differs from their anchor's keep the scan's
    # key_bytes-capped length — a rare, safe underestimate).
    # Anchor stride for the extension ladder/tail: the ~40 strided
    # gathers below run at n/stride width, so doubling the stride halves
    # the matcher's extension cost. Stride 32 measured (2026-08-21, CPU —
    # sizes are platform-independent): zlib.h x6 L6 1.0004 -> 1.0007,
    # silesia-2MiB 0.9981 -> 0.9985 vs zlib — +0.03-0.04%, inside every
    # gate, for half the extension width; default flipped to 32.
    stride = int(os.environ.get("ZZFLATE_EXT_STRIDE", "32"))
    # Anchor propagation is exact whenever key_bytes >= stride: a
    # position p with the NEXT anchor a has a - p <= stride - 1 <
    # key_bytes, and a full-key match at p (true lcp >= key_bytes)
    # therefore covers [p, a), so mlen[p] = (a-p) + mlen[a] exactly
    # when both share a distance.
    use_anchors = key_bytes >= stride and n % stride == 0
    if use_anchors:
        nq = n // stride
        posx = jnp.arange(nq, dtype=jnp.int32) * stride
        fullx = full.reshape(nq, stride)[:, 0]
        distx = mdist.reshape(nq, stride)[:, 0]
    else:
        posx = pos
        fullx = full
        distx = mdist
    candx = posx - distx

    # Extend full-key matches in key_bytes-block steps via rank equality.
    alive = fullx
    ext = jnp.zeros(posx.shape, jnp.int32)
    ext_blocks = -(-MAX_MATCH // key_bytes)  # ceil: covers to >= 258
    for k in range(1, ext_blocks):
        eq = jnp.take(
            rank_key, posx + key_bytes * k, mode="clip"
        ) == jnp.take(rank_key, candx + key_bytes * k, mode="clip")
        eq = eq & (posx + key_bytes * (k + 1) <= n)
        alive = alive & eq
        ext = ext + alive.astype(jnp.int32)

    # Tail: refine inside the first unequal key-block by direct 16-byte
    # word LCPs (exact; 8 strided gathers per round at 1/16th full
    # width beat the former full-width rank-ladder passes). A round
    # yielding < 16 equal bytes has found the mismatch — later rounds
    # are masked off.
    off = key_bytes * (ext + 1)
    alive_t = jnp.ones(off.shape, bool)
    for _ in range(key_bytes // 16):
        tp = posx + off
        tc = candx + off
        pw = [jnp.take(w[j], tp, mode="clip") for j in range(4)]
        cw = [jnp.take(w[j], tc, mode="clip") for j in range(4)]
        l16 = jnp.where(alive_t, _lcp_words(pw, cw), 0)
        off = off + l16
        alive_t = alive_t & (l16 == 16)
    extlen = off

    if use_anchors:
        # mlen at anchors (exact), then propagate to r > 0 positions.
        zero = jnp.zeros((1,), jnp.int32)
        ext_next = jnp.concatenate([extlen[1:], zero])
        dist_next = jnp.concatenate([distx[1:], zero])
        full_next = jnp.concatenate([fullx[1:], zero.astype(bool)])
        m2 = mlen.reshape(nq, stride)
        d2 = mdist.reshape(nq, stride)
        f2 = full.reshape(nq, stride)
        r = jnp.arange(stride, dtype=jnp.int32)[None, :]
        prop = (stride - r) + ext_next[:, None]
        ok_prop = (
            f2
            & full_next[:, None]
            & (d2 == dist_next[:, None])
        )
        via_anchor = jnp.where(
            r == 0,
            jnp.where(fullx[:, None], extlen[:, None], m2),
            jnp.where(ok_prop, prop, m2),
        )
        mlen = jnp.where(f2, jnp.maximum(m2, via_anchor), m2).reshape(-1)
    else:
        mlen = jnp.where(full, extlen, mlen)

    if _PROPAGATE:
        # Interior-suffix propagation: a match (len, dist) at p implies a
        # valid match (len - k, dist) at p + k for every 0 < k < len (the
        # same source window, shifted) — candidates the K-neighbor scans
        # may have missed. In packed form (len<<15 | 32768-dist) this is
        # a distance-decayed running max over the last 258 positions.
        # Strictly valid (never an overestimate), helps the lazy/optimal
        # parses pick better interior tokens.
        pk = jnp.where(
            mlen > 0,
            (mlen << 15) | (jnp.int32(WINDOW_SIZE) - mdist),
            0,
        )
        mlen, mdist = _unpack_best(_propagate(pk))

    mlen = jnp.minimum(mlen, jnp.minimum(MAX_MATCH, valid_end - pos))
    mlen = jnp.where(
        (mlen >= MIN_MATCH)
        & ~((mlen == MIN_MATCH) & (mdist > _TOO_FAR)),
        mlen,
        0,
    )
    mdist = jnp.where(mlen > 0, mdist, 0)
    return mlen, mdist


def _propagate(pk: jax.Array) -> jax.Array:
    """Distance-decayed running max of packed candidates: out[i] is the
    best of pk[i] and every pk[i-k] - k*2^15 (0 < k < 258) that still
    encodes a length >= 3, in log2(258) = 9 roll+max rounds."""
    pos = jnp.arange(pk.shape[0], dtype=jnp.int32)
    with jax.named_scope("propagate"):
        shift = 1
        while shift < MAX_MATCH:
            cand = jnp.roll(pk, shift) - (shift << 15)
            cand = jnp.where((pos >= shift) & (cand >= (3 << 15)), cand, 0)
            pk = jnp.maximum(pk, cand)
            shift *= 2
    return pk


def _lazy_take(mlen, lazy, max_lazy, nice):
    """Token choice per position: match (True) or deferred to a literal."""
    has = mlen >= MIN_MATCH
    if not lazy:
        return has
    next_len = jnp.concatenate(
        [mlen[..., 1:], jnp.zeros(mlen.shape[:-1] + (1,), mlen.dtype)],
        axis=-1,
    )
    defer = has & (mlen < max_lazy) & (next_len > mlen) & (mlen < nice)
    return has & ~defer


# Serial row sweep size. The parse is a sequential walk; the cheap axis
# is a wide vector of lanes doing tiny dependent steps. Rows of 512 bytes
# give 512-step sweeps with (chunks * n/512) parallel lanes, and exact
# results. Env-tunable (ZZFLATE_ROW) for step-count vs lane-width A/B;
# must exceed MAX_MATCH so every row's exit lands in the NEXT row (the
# P2 chain invariant).
_ROW = int(os.environ.get("ZZFLATE_ROW", "512"))
if _ROW <= MAX_MATCH:
    raise ValueError("ZZFLATE_ROW must exceed 258")


def _parse_rows_xla(step: jax.Array, starts: jax.Array) -> jax.Array:
    """Committed-position mask (B, npad) of the walk next[q] = q + step[q]
    from each chunk's start, by three serial sweeps over _ROW-wide rows.

    step: (B, npad) int32 in [1, 258], npad a multiple of _ROW;
    starts: (B,) int32. Positions before a chunk's start are unmarked.
      P1 reverse sweep: exit[p] = first landing at/after p's row end when
         walking from p (row-local recursion, one serial pass of _ROW
         steps over all rows as parallel lanes);
      P2 entry chain: row entries follow exit[] across rows (steps <= 258
         < _ROW, so each row's exit lands in the next row);
      P3 forward walk: every row walks from its entry, marking the
         committed positions (at most _ROW steps, all rows in parallel).
    """
    bch, npad = step.shape
    rows_per = npad // _ROW
    lanes = bch * rows_per
    nflat = bch * npad
    sink = jnp.int32(nflat)

    # P1: reverse exit sweep over (_ROW, lanes); exits are flat-absolute.
    st_t = step.reshape(lanes, _ROW).T  # (_ROW, lanes)
    lane_base = jnp.arange(lanes, dtype=jnp.int32) * _ROW

    def p1(t, ex):
        j = _ROW - 1 - t
        s = jax.lax.dynamic_slice(st_t, (j, 0), (1, lanes))[0]
        land = j + s
        hop = jnp.take_along_axis(
            ex, jnp.clip(land, 0, _ROW - 1)[None, :], axis=0
        )[0]
        val = jnp.where(land >= _ROW, lane_base + land, hop)
        return jax.lax.dynamic_update_slice(ex, val[None, :], (j, 0))

    ex = jax.lax.fori_loop(0, _ROW, p1, jnp.zeros((_ROW, lanes), jnp.int32))
    flat_exit = ex.T.reshape(-1)

    # P2: chain row entries per chunk ((B,)-wide, rows_per steps).
    r0 = starts // _ROW
    chunk_base = jnp.arange(bch, dtype=jnp.int32) * npad

    def p2(r, state):
        entries, e = state
        e = jnp.where(r == r0, chunk_base + starts, e)
        cur = jnp.where(r >= r0, e, sink)
        entries = jax.lax.dynamic_update_slice(entries, cur[None, :], (r, 0))
        e = flat_exit[jnp.clip(cur, 0, nflat - 1)]
        return entries, e

    entries, _ = jax.lax.fori_loop(
        0, rows_per, p2,
        (
            jnp.full((rows_per, bch), sink, jnp.int32),
            jnp.zeros((bch,), jnp.int32),
        ),
    )

    # P3: forward mark walk from every row entry in parallel.
    stepf = step.reshape(-1)
    pos0 = entries.reshape(-1)
    row_end = (jnp.clip(pos0, 0, nflat - 1) // _ROW + 1) * _ROW
    row_end = jnp.where(pos0 < nflat, row_end, 0)
    # Per-lane sink slots: within a step every live lane walks a distinct
    # row, and exited lanes each park on their OWN sink slot — the
    # scatter indices are therefore truly unique, which lets XLA skip the
    # general conflict-handling scatter path.
    lane_sink = nflat + jnp.arange(pos0.shape[0], dtype=jnp.int32)

    def p3(t, state):
        mark, pos = state
        live = pos < nflat
        idx = jnp.where(live, jnp.clip(pos, 0, nflat - 1), lane_sink)
        mark = mark.at[idx].max(
            live.astype(jnp.int8), unique_indices=True
        )
        s = stepf[jnp.clip(pos, 0, nflat - 1)]
        nxt = pos + s
        pos = jnp.where(live & (nxt < row_end), nxt, sink)
        return mark, pos

    mark, _ = jax.lax.fori_loop(
        0, _ROW, p3,
        (jnp.zeros((nflat + pos0.shape[0],), jnp.int8), pos0),
    )
    return mark[:nflat].reshape(bch, npad) == 1


def _parse_rows(step: jax.Array, starts: jax.Array) -> jax.Array:
    """The committed mask by the platform the graph is lowered for: the
    CUDA kernel on a GPU (ops/parse_kernel.py), the XLA sweeps on the
    CPU. Lowering for any other platform is an error."""
    from zzflate_tpu.ops import parse_kernel

    return jax.lax.platform_dependent(
        step, starts,
        cpu=_parse_rows_xla,
        cuda=lambda st, sv: parse_kernel.parse_rows(st, sv, _ROW),
    )


@functools.partial(jax.jit, static_argnames=("lazy",))
def parse_commit_batch(
    mlen: jax.Array,
    mdist: jax.Array,
    starts: jax.Array,
    valid_ends: jax.Array,
    lazy: bool,
    max_lazy: int | jax.Array = 258,
    nice: int | jax.Array = 258,
):
    """Greedy/lazy parse of a BATCH of chunks via serial row sweeps.

    mlen/mdist: (B, N); starts/valid_ends: (B,). Returns (committed, take)
    as (B, N) bools — identical semantics to a sequential zlib-style
    deflate_fast/deflate_slow walk (SURVEY.md C6/C7). The walk itself is
    _parse_rows over the (B, N) steps padded to whole rows.
    """
    bch, n = mlen.shape
    take = _lazy_take(mlen, lazy, max_lazy, nice)
    step = jnp.where(take, jnp.maximum(mlen, 1), 1).astype(jnp.int32)

    npad = -(-n // _ROW) * _ROW
    if npad != n:
        step = jnp.pad(step, ((0, 0), (0, npad - n)), constant_values=1)
    starts = starts.astype(jnp.int32)
    with jax.named_scope("parse"):
        committed = _parse_rows(step, starts)[:, :n]
    posn = jnp.arange(n, dtype=jnp.int32)[None, :]
    committed = (
        committed & (posn >= starts[:, None]) & (posn < valid_ends[:, None])
    )
    return committed, take & committed


@functools.partial(jax.jit, static_argnames=("lazy",))
def parse_commit(
    mlen: jax.Array,
    mdist: jax.Array,
    start: jax.Array,
    valid_end: jax.Array,
    lazy: bool,
    max_lazy: int | jax.Array = 258,
    nice: int | jax.Array = 258,
):
    """Single-chunk parse: thin wrapper over the batched serial sweep.

    Returns (committed, take): committed[p] marks token-emitting positions;
    take[p] says whether the token at p is the match (else a literal).
    """
    committed, take = parse_commit_batch(
        mlen[None], mdist[None],
        jnp.asarray(start, jnp.int32)[None],
        jnp.asarray(valid_end, jnp.int32)[None],
        lazy, max_lazy, nice,
    )
    return committed[0], take[0]
