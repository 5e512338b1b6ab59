"""Length-limited canonical Huffman construction, fully jittable.

The reference-class codec builds Huffman trees with a heap + overflow fix
(zlib's gen_bitlen shape, see SURVEY.md C10). Tree construction over <=288
symbols is negligible work next to the LZ77 stage, so on device we keep it
inside the jitted encode graph (no host round-trip per block):

- leaves sorted by (freq, symbol) via one small sort;
- the classical two-queue Huffman merge as a fori_loop of n-1 O(1) steps
  (internal nodes are created in non-decreasing weight order, so a second
  sorted queue suffices — no heap needed);
- depth assignment by walking nodes in reverse creation order;
- zlib-style bl_count overflow fix to the 15-bit (or 7-bit) limit;
- canonical redistribution: sorted-by-freq leaves take the length multiset
  in descending order, then RFC 1951 3.2.2 next_code assignment.

Everything is static-shaped; empty alphabets and 1-symbol alphabets follow
the DEFLATE conventions (a used symbol always gets length >= 1).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

# Plain int, NOT jnp.int32: a module-scope device scalar would
# initialize (and freeze) the JAX backend at import time — package
# import must never touch a device (CLI --platform and offline imports
# rely on the backend staying lazy until first compute).
_INF = 1 << 30


@functools.partial(jax.jit, static_argnames=("max_len",))
def code_lengths(freq: jax.Array, max_len: int) -> jax.Array:
    """Optimal length-limited code lengths for `freq` (int32, shape (n,)).

    Returns int32 lengths, 0 for unused symbols, in [1, max_len] for used.
    """
    n = freq.shape[0]
    freq = freq.astype(jnp.int32)
    used = freq > 0
    n_used = jnp.sum(used.astype(jnp.int32))

    # Sort leaves by (freq asc, symbol asc); unused go last. lexsort keeps
    # the two keys separate (a combined freq*2n+sym key overflows int32
    # for large frequencies).
    sym = jnp.arange(n, dtype=jnp.int32)
    freq_m = jnp.where(used, freq, _INF)
    order = jnp.lexsort((sym, freq_m)).astype(jnp.int32)
    leaf_w = jnp.where(jnp.arange(n) < n_used, freq_m[order], _INF)

    # Two-queue Huffman: n-1 static merge steps, masked beyond n_used-1.
    # Node ids: child < n means leaf rank; child >= n means node (id - n).
    def merge_step(t, state):
        leaf_ptr, node_ptr, node_cnt, node_w, ch1, ch2 = state
        active = t < n_used - 1

        def pick(lp, np_):
            lw = jnp.where(lp < n, leaf_w[jnp.minimum(lp, n - 1)], _INF)
            nw = jnp.where(np_ < node_cnt, node_w[jnp.minimum(np_, n - 1)], _INF)
            take_leaf = lw <= nw
            w = jnp.where(take_leaf, lw, nw)
            child = jnp.where(take_leaf, lp, np_ + n)
            return (
                jnp.where(take_leaf, lp + 1, lp),
                jnp.where(take_leaf, np_, np_ + 1),
                w,
                child,
            )

        lp1, np1, w1, c1 = pick(leaf_ptr, node_ptr)
        lp2, np2, w2, c2 = pick(lp1, np1)
        slot = jnp.where(active, node_cnt, n - 1)
        node_w = node_w.at[slot].set(
            jnp.where(active, w1 + w2, node_w[slot])
        )
        ch1 = ch1.at[slot].set(jnp.where(active, c1, ch1[slot]))
        ch2 = ch2.at[slot].set(jnp.where(active, c2, ch2[slot]))
        return (
            jnp.where(active, lp2, leaf_ptr),
            jnp.where(active, np2, node_ptr),
            jnp.where(active, node_cnt + 1, node_cnt),
            node_w,
            ch1,
            ch2,
        )

    init = (
        jnp.int32(0),
        jnp.int32(0),
        jnp.int32(0),
        jnp.full((n,), _INF, jnp.int32),
        jnp.zeros((n,), jnp.int32),
        jnp.zeros((n,), jnp.int32),
    )
    _, _, node_cnt, _, ch1, ch2 = jax.lax.fori_loop(0, n - 1, merge_step, init)

    # Depths: root is the last-created node; children precede parents, so a
    # reverse walk finalizes each node's depth before its children read it.
    def depth_step(i, state):
        node_depth, leaf_depth = state
        j = (n - 2) - i  # node index, descending
        active = j < node_cnt
        d = node_depth[jnp.maximum(j, 0)] + 1

        def assign(child, nd, ld):
            is_leaf = child < n
            leaf_slot = jnp.where(active & is_leaf, child, n)
            node_slot = jnp.where(active & ~is_leaf, child - n, n)
            ld = ld.at[leaf_slot].set(d, mode="drop")
            nd = nd.at[node_slot].set(d, mode="drop")
            return nd, ld

        node_depth, leaf_depth = assign(ch1[jnp.maximum(j, 0)], node_depth, leaf_depth)
        node_depth, leaf_depth = assign(ch2[jnp.maximum(j, 0)], node_depth, leaf_depth)
        return node_depth, leaf_depth

    node_depth = jnp.zeros((n,), jnp.int32)
    leaf_depth = jnp.zeros((n,), jnp.int32)
    node_depth, leaf_depth = jax.lax.fori_loop(
        0, n - 1, depth_step, (node_depth, leaf_depth)
    )
    # Single-symbol alphabet: DEFLATE still requires a 1-bit code.
    leaf_depth = jnp.where(
        n_used == 1, jnp.where(sym == 0, 1, 0), leaf_depth
    )

    # bl_count with clamping at max_len. Clamping depth d > max_len to
    # max_len strictly increases the Kraft sum, so measure the exact
    # over-subscription in integer units of 2^-max_len:
    #   K = sum over used leaves of 2^(max_len - len);  complete <=> K == 2^max_len.
    rank_used = jnp.arange(n) < n_used
    clamped = jnp.minimum(leaf_depth, max_len)
    bl_count = jnp.zeros((max_len + 1,), jnp.int32).at[
        jnp.where(rank_used, clamped, 0)
    ].add(jnp.where(rank_used, 1, 0))
    bl_count = bl_count.at[0].set(0)
    kraft = jnp.sum(
        jnp.where(
            rank_used, jnp.int32(1) << (max_len - jnp.maximum(clamped, 1)), 0
        )
    )

    # Repair: take the deepest non-empty level `bits` < max_len, turn one
    # of its leaves into an internal node whose children are itself and a
    # leaf pulled up from max_len (bl[bits]-=1, bl[bits+1]+=2,
    # bl[max_len]-=1). Each move reduces K by exactly one unit, so loop
    # until K == 2^max_len (the multiset is then a complete code).
    full = jnp.int32(1 << max_len)

    def fix_cond(state):
        bl, k = state
        return k > full

    def fix_body(state):
        bl, k = state
        lvl = jnp.arange(max_len + 1, dtype=jnp.int32)
        cand = jnp.where((lvl >= 1) & (lvl < max_len) & (bl > 0), lvl, -1)
        bits = jnp.max(cand)
        bl = bl.at[bits].add(-1)
        bl = bl.at[bits + 1].add(2)
        bl = bl.at[max_len].add(-1)
        return bl, k - 1

    bl_count, _ = jax.lax.while_loop(fix_cond, fix_body, (bl_count, kraft))

    # Redistribute: sorted-by-freq-ascending ranks take lengths descending.
    # csum[k] = number of leaves with length > max_len - 1 - k.
    desc_counts = bl_count[::-1][: max_len]  # counts for lengths max_len..1
    csum = jnp.cumsum(desc_counts)
    ranks = jnp.arange(n, dtype=jnp.int32)
    # length(rank) = max_len - (number of exhausted levels before rank).
    exhausted = jnp.sum(
        csum[None, :] <= ranks[:, None], axis=1
    ).astype(jnp.int32)
    rank_len = jnp.where(rank_used, max_len - exhausted, 0)

    lengths = jnp.zeros((n,), jnp.int32).at[order].set(rank_len)
    return jnp.where(used | (lengths > 0), lengths, 0)


@functools.partial(jax.jit, static_argnames=("max_len",))
def canonical_codes(lengths: jax.Array, max_len: int) -> jax.Array:
    """RFC 1951 3.2.2 canonical codes, already bit-reversed for LSB-first
    bitstream emission. Returns uint32, shape like `lengths`."""
    n = lengths.shape[0]
    lengths = lengths.astype(jnp.int32)
    bl_count = jnp.zeros((max_len + 1,), jnp.int32).at[lengths].add(
        jnp.where(lengths > 0, 1, 0)
    )
    bl_count = bl_count.at[0].set(0)

    def nc_step(bits, state):
        code, next_code = state
        code = (code + bl_count[bits - 1]) << 1
        return code, next_code.at[bits].set(code)

    _, next_code = jax.lax.fori_loop(
        1, max_len + 1, nc_step, (jnp.int32(0), jnp.zeros((max_len + 1,), jnp.int32))
    )
    # Rank of each symbol within its length class (symbol order).
    onehot = (lengths[:, None] == jnp.arange(max_len + 1)[None, :]).astype(
        jnp.int32
    )
    rank = jnp.cumsum(onehot, axis=0) - onehot  # exclusive prefix count
    my_rank = jnp.take_along_axis(rank, lengths[:, None], axis=1)[:, 0]
    codes = (next_code[lengths] + my_rank).astype(jnp.uint32)

    # Bit-reverse the low `lengths` bits of each code.
    rev = jnp.zeros_like(codes)
    c = codes
    for _ in range(max_len):
        rev = (rev << jnp.uint32(1)) | (c & jnp.uint32(1))
        c = c >> jnp.uint32(1)
    rev = rev >> (jnp.uint32(max_len) - lengths.astype(jnp.uint32))
    return jnp.where(lengths > 0, rev, 0).astype(jnp.uint32)


def histogram(symbols: jax.Array, valid: jax.Array, n: int) -> jax.Array:
    """Masked bincount of `symbols` where `valid`, into `n` bins (int32).

    Computed as a comparison + axis reduction rather than a scatter-add:
    colliding-index scatters serialize on their conflicts, while the
    (N, n) compare fuses into the reduction without materializing.
    """
    idx = jnp.where(valid, symbols, -1).astype(jnp.int32)
    bins = jnp.arange(n, dtype=jnp.int32)
    return jnp.sum(
        (idx[:, None] == bins[None, :]).astype(jnp.int32), axis=0
    )
