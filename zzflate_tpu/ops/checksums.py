"""Adler-32 and CRC-32 as data-parallel JAX ops, plus host combine math.

The reference codec computes both checksums with a sequential byte loop
(zlib contract: zlib.h:1689 adler32, zlib.h:1727 crc32). On device we instead
exploit that both checksums are *linear enough* to tree-combine:

- Adler-32: for a segment x of length m define S(x) = sum(x) mod 65521 and
  W(x) = sum(x[i] * (m - i)) mod 65521.  Then S/W combine associatively:
  S(L||R) = S(L)+S(R);  W(L||R) = W(L) + len(R)*S(L) + W(R).  The final
  checksum is s1 = init_s1 + S, s2 = init_s2 + n*init_s1 + W (mod 65521).
- CRC-32: the byte-update map state' = (state>>8) ^ T[(state^b)&0xFF]
  factors as A(state) ^ T[b] with A linear over GF(2), so the zero-init
  state after n bytes is c = XOR_i A^(n-1-i) T[b_i], which tree-combines as
  c(L||R) = A^len(R) c(L) ^ c(R) using precomputed GF(2) matrices A^(2^j).

Both give per-shard partials + O(log n) combines: the multi-chip encode
computes shard checksums on-device and the host merges them in O(#shards).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

ADLER_MOD = 65521
CRC_POLY = 0xEDB88320

# ---------------------------------------------------------------------------
# Host-side tables (numpy, computed once at import).
# ---------------------------------------------------------------------------


def _crc_table() -> np.ndarray:
    table = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (CRC_POLY if (c & 1) else 0)
        table[i] = c
    return table


CRC_TABLE = _crc_table()


def _crc_shift_matrix() -> np.ndarray:
    """GF(2) matrix of A(s) = (s>>8) ^ T[s & 0xFF] as 32 uint32 columns.

    Column k is A(1<<k); A(v) = XOR of columns where v has a 1 bit.
    """
    cols = np.zeros(32, dtype=np.uint32)
    for k in range(32):
        v = np.uint32(1 << k)
        cols[k] = (v >> np.uint32(8)) ^ CRC_TABLE[int(v & np.uint32(0xFF))]
    return cols


def _mat_apply(cols: np.ndarray, v: int) -> int:
    out = 0
    for k in range(32):
        if (v >> k) & 1:
            out ^= int(cols[k])
    return out


def _mat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Compose GF(2) matrices (column form): result = a @ b."""
    out = np.zeros(32, dtype=np.uint32)
    for k in range(32):
        out[k] = _mat_apply(a, int(b[k]))
    return out


def _mat_inv(a: np.ndarray) -> np.ndarray:
    """Invert a GF(2) 32x32 matrix given as uint32 columns (Gauss-Jordan)."""
    m = [[(int(a[c]) >> r) & 1 for c in range(32)] for r in range(32)]
    inv = [[1 if r == c else 0 for c in range(32)] for r in range(32)]
    for col in range(32):
        piv = next(r for r in range(col, 32) if m[r][col])
        m[col], m[piv] = m[piv], m[col]
        inv[col], inv[piv] = inv[piv], inv[col]
        for r in range(32):
            if r != col and m[r][col]:
                m[r] = [x ^ y for x, y in zip(m[r], m[col])]
                inv[r] = [x ^ y for x, y in zip(inv[r], inv[col])]
    cols = np.zeros(32, dtype=np.uint32)
    for c in range(32):
        v = 0
        for r in range(32):
            v |= inv[r][c] << r
        cols[c] = v
    return cols


_MAX_LOG = 40  # supports lengths up to 2^40 bytes


def _pow_matrices() -> tuple[np.ndarray, np.ndarray]:
    """A^(2^j) and A^(-2^j) for j in [0, _MAX_LOG), as (J, 32) uint32."""
    fwd = np.zeros((_MAX_LOG, 32), dtype=np.uint32)
    fwd[0] = _crc_shift_matrix()
    for j in range(1, _MAX_LOG):
        fwd[j] = _mat_mul(fwd[j - 1], fwd[j - 1])
    inv0 = _mat_inv(fwd[0])
    bwd = np.zeros((_MAX_LOG, 32), dtype=np.uint32)
    bwd[0] = inv0
    for j in range(1, _MAX_LOG):
        bwd[j] = _mat_mul(bwd[j - 1], bwd[j - 1])
    return fwd, bwd


CRC_POW, CRC_POW_INV = _pow_matrices()


# ---------------------------------------------------------------------------
# Host combine math (python ints) — used when stitching shard outputs.
# ---------------------------------------------------------------------------


def crc32_shift(crc: int, nbytes: int) -> int:
    """Apply A^nbytes to a zero-init CRC state (host)."""
    out = crc
    j = 0
    while nbytes:
        if nbytes & 1:
            out = _mat_apply(CRC_POW[j], out)
        nbytes >>= 1
        j += 1
    return out


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """crc32(A||B) from crc32(A), crc32(B), len(B). Matches zlib.h:1752.

    With R(x, init) = A^len(x) init ^ C(x) (C = zero-init contribution) and
    crc = ~R(x, ~0): the init/xorout terms cancel so that
    crc(A||B) = A^len(B)(crc(A)) ^ crc(B).
    """
    return crc32_shift(crc1, len2) ^ crc2


def adler32_combine(adler1: int, adler2: int, len2: int) -> int:
    """adler32(A||B) from the two adlers and len(B). Matches zlib.h:1716.

    s1(AB) = s1(A) + s1(B) - 1;  s2(AB) = s2(A) + s2(B) + len(B)*(s1(A)-1),
    from s2(X) = len(X) + sum_i x_i*(len(X)-i) and s1 init 1 / s2 init 0.
    """
    m = ADLER_MOD
    rem = len2 % m
    s1a, s2a = adler1 & 0xFFFF, (adler1 >> 16) & 0xFFFF
    s1b, s2b = adler2 & 0xFFFF, (adler2 >> 16) & 0xFFFF
    s1 = (s1a + s1b - 1) % m
    s2 = (s2a + s2b + rem * (s1a - 1)) % m
    return (s2 << 16) | s1


# ---------------------------------------------------------------------------
# JAX kernels.
# ---------------------------------------------------------------------------

_BLOCK = 1024  # level-0 block for adler tree; keeps i32 partials exact.


def _ceil_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


@functools.partial(jax.jit, static_argnames=("block",))
def _adler32_impl(
    data: jax.Array,
    length: jax.Array,
    start: jax.Array = 0,
    block: int = _BLOCK,
):
    """Adler-32 of data[start:length].

    Leading zeros are transparent to the S/W partials (x=0 contributes
    nothing, and W's weight (length - i) equals the in-chunk weight), so
    only the final n term needs the true chunk length.
    """
    n_pad = data.shape[0]
    assert n_pad % block == 0
    m = jnp.uint32(ADLER_MOD)
    idx = jnp.arange(n_pad)
    data = jnp.where((idx >= start) & (idx < length), data, 0)
    x = data.astype(jnp.int32).reshape(-1, block)
    weights = (block - jnp.arange(block, dtype=jnp.int32)).reshape(1, block)
    s = (jnp.sum(x, axis=1).astype(jnp.uint32)) % m
    w = (jnp.sum(x * weights, axis=1).astype(jnp.uint32)) % m
    seg = block
    # Tree combine: at each level pairs of equal-length segments merge.
    # Odd levels append an implicit all-zero segment, growing the effective
    # padded length; track it so the final correction is exact.
    while s.shape[0] > 1:
        if s.shape[0] % 2:
            s = jnp.concatenate([s, jnp.zeros((1,), jnp.uint32)])
            w = jnp.concatenate([w, jnp.zeros((1,), jnp.uint32)])
        sl, sr = s[0::2], s[1::2]
        wl, wr = w[0::2], w[1::2]
        seg_mod = jnp.uint32(seg % ADLER_MOD)
        w = (wl + ((seg_mod * sl) % m) + wr) % m
        s = (sl + sr) % m
        seg = seg * 2
    s_total, w_pad = s[0], w[0]
    effective_total = seg  # = block * 2^levels, the length W was computed over
    # Right-padding correction: padded zero bytes inflate every weight by
    # (effective_total - length); W_true = W_pad - pad*S  (mod m).
    pad = (jnp.uint32(effective_total) - length.astype(jnp.uint32)) % m
    w_true = (w_pad + ((m - pad) % m) * s_total % m) % m
    n_mod = (length - start).astype(jnp.uint32) % m
    s1 = (jnp.uint32(1) + s_total) % m
    s2 = (n_mod + w_true) % m
    return (s2 << jnp.uint32(16)) | s1


def adler32(data, length=None, start=0) -> jax.Array:
    """Adler-32 of data[start:length] (uint8 array). Returns uint32 scalar."""
    data = jnp.asarray(data, dtype=jnp.uint8)
    n = data.shape[0]
    if length is None:
        length = n
    n_pad = max(_BLOCK, ((n + _BLOCK - 1) // _BLOCK) * _BLOCK)
    if n_pad != n:
        data = jnp.pad(data, (0, n_pad - n))
    return _adler32_impl(
        data, jnp.asarray(length, jnp.int32), jnp.asarray(start, jnp.int32)
    )


def _gf_matvec_batch(cols: jax.Array, v: jax.Array) -> jax.Array:
    """Apply a GF(2) matrix (32 uint32 columns) to a batch of uint32."""
    out = jnp.zeros_like(v)
    for k in range(32):
        bit = (v >> jnp.uint32(k)) & jnp.uint32(1)
        out = out ^ (bit * cols[k])
    return out


@jax.jit
def _crc32_impl(data: jax.Array, length: jax.Array, start: jax.Array = 0):
    """CRC-32 of data[start:length].

    Leading zeros are transparent to the zero-init contribution (T[0]==0
    and A(0)==0); only the init-fold term needs the true chunk length.
    """
    n_pad = data.shape[0]
    table = jnp.asarray(CRC_TABLE)
    pow_fwd = jnp.asarray(CRC_POW)
    pow_inv = jnp.asarray(CRC_POW_INV)
    # Per-byte contributions T[b_i]; bytes outside [start, length) are
    # masked to zero (T[0] == 0, so they contribute nothing).
    idx = jnp.arange(n_pad)
    data = jnp.where((idx >= start) & (idx < length), data, 0)
    c = table[data.astype(jnp.int32)]
    # Tree combine: c(L||R) = A^len(R) c(L) ^ c(R); len(R) = 2^j at level j.
    # Odd levels append an implicit all-zero segment (zero contribution is
    # exact for zero bytes); track the effective total length so the final
    # right-padding correction stays right for non-power-of-two inputs.
    level = 0
    eff_total = n_pad
    while c.shape[0] > 1:
        if c.shape[0] % 2:
            c = jnp.concatenate([c, jnp.zeros((1,), jnp.uint32)])
            eff_total += 1 << level
        cl, cr = c[0::2], c[1::2]
        c = _gf_matvec_batch(pow_fwd[level], cl) ^ cr
        level += 1
    c_pad = c[0]
    # Undo right zero-padding: c_pad = A^pad(c_true).
    pad = jnp.uint32(eff_total) - length.astype(jnp.uint32)
    c_true = c_pad
    for j in range(_MAX_LOG):
        bit = (pad >> jnp.uint32(j)) & jnp.uint32(1)
        shifted = _gf_matvec_batch(pow_inv[j], c_true[None])[0]
        c_true = jnp.where(bit == 1, shifted, c_true)
    # Fold in the 0xFFFFFFFF init shifted over length, and the final xorout.
    init = jnp.uint32(0xFFFFFFFF)
    nlen = (length - start).astype(jnp.uint32)
    for j in range(_MAX_LOG):
        bit = (nlen >> jnp.uint32(j)) & jnp.uint32(1)
        shifted = _gf_matvec_batch(pow_fwd[j], init[None])[0]
        init = jnp.where(bit == 1, shifted, init)
    return init ^ c_true ^ jnp.uint32(0xFFFFFFFF)


def crc32(data, length=None, start=0) -> jax.Array:
    """CRC-32 (zlib/gzip polynomial) of data[start:length]. Returns uint32."""
    data = jnp.asarray(data, dtype=jnp.uint8)
    n = data.shape[0]
    if length is None:
        length = n
    n_pad = max(1, _ceil_pow2(n))
    if n_pad != n:
        data = jnp.pad(data, (0, n_pad - n))
    return _crc32_impl(
        data, jnp.asarray(length, jnp.int32), jnp.asarray(start, jnp.int32)
    )
