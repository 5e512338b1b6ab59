"""LSB-first bitstream packing as a prefix-sum + scatter (no serial loop).

The reference-class codec packs codes with a sequential bit-buffer
(SURVEY.md C1: write_bits/flush_to_byte). Here the whole block becomes one
field stream [(value, nbits), ...] with nbits=0 meaning "absent" (which is
how conditional fields — dynamic header present/absent, literal vs match —
are expressed without dynamic shapes). An exclusive prefix sum of nbits
gives each field its absolute bit offset; every field is <= 16 bits so it
touches at most two little-endian u32 words, written with two scatter-adds
(disjoint bit ranges make add == or).

Bit order: DEFLATE packs LSB-first within each byte (SURVEY.md A.1), so
stream bit i lands in u32 word i>>5 at bit i&31 when words are serialized
little-endian — values can be OR-shifted in directly. Huffman codes must be
pre-bit-reversed (ops/huffman.canonical_codes already returns them so).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("out_words", "report_indices"))
def pack_fields(
    values: jax.Array,
    nbits: jax.Array,
    out_words: int,
    report_indices: tuple = (),
):
    """Pack a field stream into a little-endian u32 word buffer.

    Args:
      values: (F,) uint32 field values (low `nbits` bits are emitted).
      nbits: (F,) int32 bit widths, 0..16; 0 fields are skipped.
      out_words: static output buffer size in u32 words.
      report_indices: static field indices whose BIT OFFSETS are also
        returned (used to index block starts inside the stream).

    Returns:
      (words, total_bits[, report_offsets]): (out_words,) uint32, scalar
      int32, and (len(report_indices),) int32 when requested. If
      total_bits > 32*out_words the buffer content is unspecified (the
      caller falls back to a stored block).
    """
    nbits = nbits.astype(jnp.int32)
    values = values.astype(jnp.uint32) & ((jnp.uint32(1) << nbits.astype(jnp.uint32)) - 1)
    offsets = jnp.cumsum(nbits) - nbits  # exclusive prefix sum
    total_bits = offsets[-1] + nbits[-1] if nbits.shape[0] else jnp.int32(0)
    report = (
        jnp.take(offsets, jnp.asarray(report_indices, jnp.int32))
        if report_indices
        else None
    )

    word_idx = (offsets >> 5).astype(jnp.int32)
    bit_idx = (offsets & 31).astype(jnp.uint32)
    lo = values << bit_idx
    # val >> (32 - b) is UB at b=0; two-step shift keeps it defined.
    hi = (values >> (jnp.uint32(31) - bit_idx)) >> jnp.uint32(1)

    # Offsets are monotone, so word_idx is sorted — keep the scatter
    # indices sorted (absent fields contribute zeros at their in-order
    # word rather than a sortedness-breaking sentinel) and tell XLA:
    # sorted scatter-adds can take a cheaper lowering than the general
    # atomic path (values are pre-masked, so absent fields and
    # empty high words add 0 — add == or on disjoint bit ranges).
    words = jnp.zeros((out_words,), jnp.uint32)
    words = words.at[word_idx].add(
        lo, mode="drop", indices_are_sorted=True
    )
    words = words.at[word_idx + 1].add(
        hi, mode="drop", indices_are_sorted=True
    )
    if report is not None:
        return words, total_bits, report
    return words, total_bits


def scatter_fields(words, offsets, values, nbits, out_words: int):
    """OR fields into an existing u32 word buffer at absolute bit offsets.

    Same two-scatter-add trick as pack_fields but with caller-computed
    offsets: any field layout whose offsets are known in closed form can
    skip materializing an interleaved (value, nbits) stream. Fields may be
    up to 31 bits wide (they still span at most two u32 words)."""
    nbits = nbits.astype(jnp.int32)
    values = values.astype(jnp.uint32) & (
        (jnp.uint32(1) << nbits.astype(jnp.uint32)) - 1
    )
    word_idx = (offsets >> 5).astype(jnp.int32)
    bit_idx = (offsets & 31).astype(jnp.uint32)
    lo = values << bit_idx
    hi = (values >> (jnp.uint32(31) - bit_idx)) >> jnp.uint32(1)
    # Caller-supplied offsets here are monotone too (field streams and
    # header layouts are emitted in order); sorted scatter-adds of
    # pre-masked values (absent -> 0) skip the general scatter path.
    words = words.at[word_idx].add(
        lo, mode="drop", indices_are_sorted=True
    )
    return words.at[word_idx + 1].add(
        hi, mode="drop", indices_are_sorted=True
    )


def scatter_field48(words, offsets, lo, hi, nbits, out_words: int):
    """OR fields of up to 48 bits into the buffer at absolute bit offsets.

    The field value arrives pre-split as lo (low 32 bits) and hi (bits
    32..47); values must already be masked to `nbits` total. A 48-bit
    field at an arbitrary bit offset spans at most THREE u32 words —
    three scatter-adds replace the four that two 32-bit-field passes
    would need (disjoint bit ranges make add == or)."""
    nbits = nbits.astype(jnp.int32)
    lo = lo.astype(jnp.uint32)
    hi = hi.astype(jnp.uint32)
    word_idx = (offsets >> 5).astype(jnp.int32)
    b = (offsets & 31).astype(jnp.uint32)
    w0 = lo << b
    # x >> (32 - b) is UB at b=0; the two-step shift keeps it defined.
    w1 = ((lo >> (jnp.uint32(31) - b)) >> jnp.uint32(1)) | (hi << b)
    w2 = (hi >> (jnp.uint32(31) - b)) >> jnp.uint32(1)
    # Token bit offsets are monotone: scatter all three word lanes with
    # sorted indices (absent fields are pre-masked to zero values, so
    # they add 0 at their in-order slot instead of branching to a
    # sortedness-breaking drop sentinel).
    words = words.at[word_idx].add(
        w0, mode="drop", indices_are_sorted=True
    )
    words = words.at[word_idx + 1].add(
        w1, mode="drop", indices_are_sorted=True
    )
    return words.at[word_idx + 2].add(
        w2, mode="drop", indices_are_sorted=True
    )


def words_to_bytes(words, total_bits: int) -> bytes:
    """Serialize the packed words to the byte stream (host)."""
    import numpy as np

    nbytes = (int(total_bits) + 7) // 8
    return np.asarray(words, dtype="<u4").tobytes()[:nbytes]
