"""Multi-host distributed encode (SURVEY.md M6 / section 5.8).

The reference is a single-process library; scaling across hosts is pure
data parallelism with a one-hop halo, exactly like the single-host chunk
scheme lifted one level:

  host i's byte range is chunked locally (parallel/sharded over its own
  chips); its first chunk uses host i-1's 32 KiB tail as the preset
  dictionary (halo exchange = one allgather of tiny tails); every host's
  payload is sync-flush framed; host N-1 closes the stream; process 0
  concatenates payloads in host order and merges the per-host checksum
  partials with the closed-form combines. The result is ONE valid
  zlib/gzip member, identical to what a single host would produce with
  the same chunking.

Small metadata (sizes, checksums, halo tails) and the ragged payload
bytes move via jax.experimental.multihost_utils allgathers, the payloads
in bounded slabs (_gather_payloads_to_root). Runs degenerate (and is
tested) at process_count() == 1; with several processes call
initialize() first.
"""
from __future__ import annotations

import numpy as np

import jax

from zzflate_tpu import config as cfg_mod
from zzflate_tpu.api import _encode_segments
from zzflate_tpu.config import CodecConfig
from zzflate_tpu.ops.checksums import adler32_combine, crc32_combine
from zzflate_tpu.utils import containers

_WINDOW = 32768


def initialize(coordinator_address=None, num_processes=None, process_id=None):
    """jax.distributed.initialize passthrough (no-op if already set up)."""
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError:
        pass  # already initialized


def _allgather_np(arr: np.ndarray) -> np.ndarray:
    """All-gather a host-local numpy array along a new leading axis."""
    if jax.process_count() == 1:
        return arr[None]
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(arr))


def _gather_payloads_to_root(
    payload: bytes, metas: np.ndarray, pid: int, nproc: int
) -> list[bytes] | None:
    """Collect every host's ragged payload on process 0.

    A symmetric slab allgather in bounded rounds: only process 0
    accumulates, so a non-root host's peak memory is O(slab); wire
    traffic is O(hosts x total). Returns the per-host payload list on
    process 0, None elsewhere.
    """
    if nproc == 1:
        return [payload] if pid == 0 else None

    max_len = int(metas[:, 0].max())
    SLAB = 4 << 20
    rounds = max(1, -(-max_len // SLAB))
    acc = [bytearray() for _ in range(nproc)] if pid == 0 else None
    for r in range(rounds):
        slab = np.zeros(SLAB, np.uint8)
        piece = payload[r * SLAB : (r + 1) * SLAB]
        if piece:
            slab[: len(piece)] = np.frombuffer(piece, np.uint8)
        got = _allgather_np(slab)
        if pid == 0:
            for i in range(nproc):
                take = min(SLAB, int(metas[i, 0]) - r * SLAB)
                if take > 0:
                    acc[i] += got[i, :take].tobytes()
        del got
    return [bytes(p) for p in acc] if pid == 0 else None


def compress_multihost(
    local_data: bytes,
    level: int = 6,
    format: str = "gzip",
    chunk_bytes: int = cfg_mod.DEFAULT_CHUNK_BYTES,
    use_halo: bool = True,
) -> bytes | None:
    """Distributed one-shot compress of a byte stream sharded across hosts.

    Each process passes ITS contiguous byte range (process order = byte
    order). Returns the complete stream on process 0, None elsewhere.
    """
    config = CodecConfig(level=level, format=format, chunk_bytes=chunk_bytes)
    pid = jax.process_index()
    nproc = jax.process_count()

    # Halo: every host publishes its 32 KiB tail; host i seeds its first
    # chunk with host i-1's tail (the cross-host sequence-parallel hop).
    tail = np.zeros(_WINDOW + 4, np.uint8)
    t = local_data[-_WINDOW:]
    tail[: len(t)] = np.frombuffer(t, np.uint8)
    tail[_WINDOW:] = np.frombuffer(
        np.array([len(t)], np.uint32).tobytes(), np.uint8
    )
    tails = _allgather_np(tail)
    dictionary = None
    if use_halo and pid > 0:
        prev_len = int(
            np.frombuffer(tails[pid - 1, _WINDOW:].tobytes(), np.uint32)[0]
        )
        dictionary = tails[pid - 1, :prev_len].tobytes()

    last = pid == nproc - 1
    res = _encode_segments(
        local_data,
        config,
        dictionary,
        stream_final=last,
        with_checksums=True,
    )
    payload = b"".join(res["segments"])
    nchunks = max(1, -(-len(local_data) // chunk_bytes))
    lens = [
        min(chunk_bytes, len(local_data) - i * chunk_bytes)
        for i in range(nchunks)
    ]
    adler = containers.combine_adler(list(zip(res["adler"], lens)))
    crc = containers.combine_crc(list(zip(res["crc"], lens)))

    # Gather ragged payloads to process 0: sizes first, then the bytes
    # in bounded allgather slabs.
    meta = np.array(
        [len(payload), len(local_data), adler, crc], np.int64
    )
    metas = _allgather_np(meta)
    per_host = _gather_payloads_to_root(payload, metas, pid, nproc)

    if pid != 0:
        return None
    full_payload = b"".join(per_host)
    total_len = int(metas[:, 1].sum())
    full_adler, full_crc = 1, 0
    for i in range(nproc):
        ln = int(metas[i, 1])
        full_adler = adler32_combine(full_adler, int(metas[i, 2]), ln)
        full_crc = crc32_combine(full_crc, int(metas[i, 3]), ln)

    if format == "raw":
        return full_payload
    if format == "zlib":
        return (
            containers.zlib_header(level)
            + full_payload
            + containers.zlib_trailer(full_adler)
        )
    return (
        containers.gzip_header()
        + full_payload
        + containers.gzip_trailer(full_crc, total_len)
    )
