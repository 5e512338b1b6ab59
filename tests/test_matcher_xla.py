"""The matcher's neighbour scan, match propagation and row-sweep parse
against plain NumPy/Python references written from their definitions."""
import numpy as np
import pytest

import jax.numpy as jnp

from zzflate_tpu.constants import MAX_MATCH, MIN_MATCH, WINDOW_SIZE
from zzflate_tpu.ops import matcher as M


def _words_of(rows: np.ndarray) -> list:
    """(n, nwords) u32 big-endian key words -> the matcher's word list."""
    return [jnp.asarray(rows[:, j]) for j in range(rows.shape[1])]


def _brute_scan(rows, spos, window_start, k_each, backward_only, best):
    """Best (len, then nearest) candidate among the k_each sort-order
    neighbours on each side, by direct byte compares of the keys."""
    n, nw = rows.shape
    key = rows.astype(">u4").view(np.uint8).reshape(n, 4 * nw)
    out = best.copy()
    for i in range(n):
        bl, bd = 0, 0
        offs = [-k for k in range(1, k_each + 1)]
        if not backward_only:
            offs += list(range(1, k_each + 1))
        for o in offs:
            j = i + o
            if not 0 <= j < n:
                continue
            dist = int(spos[i]) - int(spos[j])
            if not (1 <= dist <= WINDOW_SIZE and spos[j] >= window_start):
                continue
            diff = np.nonzero(key[i] != key[j])[0]
            ln = int(diff[0]) if len(diff) else 4 * nw
            if ln > bl or (ln == bl and ln > 0 and dist < bd):
                bl, bd = ln, dist
        if bl > 0:
            p = int(spos[i])
            out[p] = max(out[p], (bl << 15) | (WINDOW_SIZE - bd))
    return out


def _sorted_suffix_words(data: bytes, nwords: int):
    n = len(data)
    padded = np.frombuffer(data + bytes(4 * nwords + 4), np.uint8)
    rows = np.zeros((n, nwords), np.uint32)
    for j in range(nwords):
        for b in range(4):
            rows[:, j] |= padded[4 * j + b : 4 * j + b + n].astype(
                np.uint32
            ) << (24 - 8 * b)
    order = np.lexsort(tuple(rows[:, j] for j in reversed(range(nwords))))
    return rows[order], order.astype(np.int32)


def _run_scan(rows, spos, ws, k_each, backward_only, best):
    n = rows.shape[0]
    got, _ = M._scan_order(
        _words_of(rows), jnp.asarray(spos), jnp.arange(n, dtype=jnp.int32),
        jnp.int32(ws), jnp.asarray(best), k_each, 4 * rows.shape[1], n,
        backward_only=backward_only,
    )
    return np.asarray(got)


@pytest.mark.parametrize("backward_only", [False, True])
@pytest.mark.parametrize("k_each", [1, 8, 16])
def test_scan_matches_brute_force(k_each, backward_only):
    rng = np.random.default_rng(k_each + int(backward_only))
    data = bytes(rng.choice(np.frombuffer(b"abc", np.uint8), 1000))
    rows, spos = _sorted_suffix_words(data, 4)
    best = np.where(rng.random(1000) < 0.2, (5 << 15) | 77, 0).astype(
        np.int32
    )
    got = _run_scan(rows, spos, 37, k_each, backward_only, best)
    exp = _brute_scan(rows, spos, 37, k_each, backward_only, best)
    assert (got == exp).all()
    assert (got != best).any()


def test_scan_window_edges():
    # Pair i = positions (i, i + 32766 + i % 5) shares a key no other
    # pair has, so each pair's second position sees its first at a
    # distance straddling the 32 KiB window; the window starts at 3.
    m = 600
    n = WINDOW_SIZE + 2 * m
    a = np.arange(m)
    b = a + WINDOW_SIZE - 2 + a % 5
    rest = np.setdiff1d(np.arange(n), np.concatenate([a, b]))
    spos = np.concatenate([np.stack([a, b], 1).reshape(-1), rest])
    spos = spos.astype(np.int32)
    rows = np.full((n, 4), 0x61626364, np.uint32)
    rows[: 2 * m, 0] = np.repeat(a, 2)
    rows[2 * m :, 0] = 0xFFFFFFFF
    best = np.zeros((n,), np.int32)
    got = _run_scan(rows, spos, 3, 4, False, best)
    exp = _brute_scan(rows, spos, 3, 4, False, best)
    assert (got == exp).all()
    ln, dist = got[b] >> 15, WINDOW_SIZE - (got[b] & (WINDOW_SIZE - 1))
    inside = (b - a <= WINDOW_SIZE) & (a >= 3)
    assert (ln[inside] == 16).all() and (dist[inside] == (b - a)[inside]).all()
    assert (ln[~inside] < 16).all()


@pytest.mark.parametrize("n", [1000, 4096, 12345])
def test_propagate_closed_form(n):
    rng = np.random.default_rng(n)
    mlen = rng.integers(MIN_MATCH, MAX_MATCH + 1, size=n)
    mlen = np.where(rng.random(n) < 0.6, 0, mlen)
    mdist = rng.integers(1, WINDOW_SIZE + 1, size=n)
    pk = np.where(mlen > 0, (mlen << 15) | (WINDOW_SIZE - mdist), 0)
    got = np.asarray(M._propagate(jnp.asarray(pk, jnp.int32)))
    exp = pk.astype(np.int64).copy()
    for k in range(1, 256):
        cand = np.zeros(n, np.int64)
        cand[k:] = pk[:-k].astype(np.int64) - (k << 15)
        exp = np.maximum(exp, np.where(cand >= 3 << 15, cand, 0))
    assert (got == exp).all()


def _serial_parse(mlen, start, vend, lazy, max_lazy, nice):
    """zlib-style greedy / lazy walk over one chunk's match lengths."""
    n = len(mlen)
    com = np.zeros(n, bool)
    take = np.zeros(n, bool)
    p = start
    while p < n:
        ln = int(mlen[p])
        nxt = int(mlen[p + 1]) if p + 1 < n else 0
        use = ln >= MIN_MATCH and not (
            lazy and ln < max_lazy and nxt > ln and ln < nice
        )
        if p < vend:
            com[p] = True
            take[p] = use
        p += ln if use else 1
    return com, take


@pytest.mark.parametrize("lazy", [False, True])
def test_parse_matches_serial_walk(lazy):
    rng = np.random.default_rng(7)
    B, N = 3, 2048 + 123  # N not a multiple of the row size
    mlen = np.where(
        rng.random((B, N)) < 0.3, rng.integers(3, 259, (B, N)), 0
    ).astype(np.int32)
    mdist = np.where(mlen > 0, rng.integers(1, 1000, (B, N)), 0).astype(
        np.int32
    )
    starts = np.array([700, 0, 1500], np.int32)
    vends = np.array([N - 9, N, N - 300], np.int32)
    max_lazy, nice = 32, 200
    com, take = M.parse_commit_batch(
        jnp.asarray(mlen), jnp.asarray(mdist), jnp.asarray(starts),
        jnp.asarray(vends), lazy, max_lazy, nice,
    )
    for b in range(B):
        ec, et = _serial_parse(mlen[b], starts[b], vends[b], lazy,
                               max_lazy, nice)
        assert np.array_equal(np.asarray(com[b]), ec)
        assert np.array_equal(np.asarray(take[b]), et)
    assert np.asarray(take).sum() > 0
