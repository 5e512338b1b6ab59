"""Benchmark: end-to-end encode throughput vs single-thread zlib level 6.

Prints TWO JSON lines (the two engines are separate metrics, never
substituted for each other):

  {"metric": "encode_MBps_level6", ...}          # device pipeline
  {"metric": "encode_MBps_level6_native", ...}   # host C engine

The corpus is the deterministic 8 MiB mixed recipe from BASELINE.md
(headers + XML-ish text + binary), regenerated locally so the numbers are
comparable across rounds. Everything else (ratio, per-stage info) goes to
stderr. Runs on JAX's default device; a device failure fails the run.

--scaling: CPU-mesh scaling proxy (1/2/4/8 simulated devices, fixed
total bytes through parallel.compress_sharded) — the machinery's
overhead on virtual devices; `chip_smoke.py --cards 4` runs real cards.
--full [--mib=N]: per-level ratio table on the Silesia-like fixture.
"""
from __future__ import annotations

import glob
import json
import sys
import time
import zlib

import numpy as np

import os as _os

CHUNK_BYTES = int(_os.environ.get("ZZFLATE_BENCH_CHUNK", 1 << 18))
LEVEL = 6
TARGET_BYTES = int(float(_os.environ.get("ZZFLATE_BENCH_MIB", "8")) * (1 << 20))
REPS = 3


def build_corpus(target: int = TARGET_BYTES) -> bytes:
    parts = []
    total = 0
    # 1) C headers (text, highly compressible, long-range repeats)
    for path in sorted(glob.glob("/usr/include/*.h"))[:200]:
        try:
            b = open(path, "rb").read()
        except OSError:
            continue
        parts.append(b)
        total += len(b)
        if total >= target // 2:
            break
    # 2) synthetic XML-ish records (mid compressibility, deterministic)
    rng = np.random.default_rng(1234)
    ids = rng.integers(0, 10**9, size=20000)
    xml = "".join(
        f"<row id='{i}' v='{i % 997}'><name>item-{i % 5000}</name></row>\n"
        for i in ids
    ).encode()
    parts.append(xml[: target // 4])
    # 3) binary (an ELF if present, else pseudo-random = stored fallback)
    try:
        elf = open("/usr/bin/python3.12", "rb").read()[: target // 4]
    except OSError:
        elf = rng.integers(0, 256, size=target // 4, dtype=np.uint8).tobytes()
    parts.append(elf)
    data = b"".join(parts)[:target]
    if len(data) < target:
        data = (data * (target // max(1, len(data)) + 1))[:target]
    return data


def full_ratio_table(target_mib: int = 100) -> None:
    """--full: per-level ratio table on the Silesia-like fixture
    (ours vs zlib vs libdeflate); results recorded in BASELINE.md."""
    import ctypes

    import zzflate_tpu as zf
    from zzflate_tpu.utils import fixtures

    data = fixtures.silesia_like(target_mib << 20)
    mb = len(data) / 1e6

    libd = None
    try:
        libd = ctypes.CDLL("libdeflate.so.0")
        libd.libdeflate_alloc_compressor.restype = ctypes.c_void_p
        libd.libdeflate_zlib_compress.restype = ctypes.c_size_t
    except OSError:
        pass

    def libdeflate_size(level: int) -> int | None:
        if libd is None:
            return None
        comp = libd.libdeflate_alloc_compressor(ctypes.c_int(level))
        bound = len(data) + len(data) // 2 + 1024
        buf = ctypes.create_string_buffer(bound)
        n = libd.libdeflate_zlib_compress(
            ctypes.c_void_p(comp), data, ctypes.c_size_t(len(data)),
            buf, ctypes.c_size_t(bound),
        )
        libd.libdeflate_free_compressor(ctypes.c_void_p(comp))
        return int(n) or None

    print(f"fixture={len(data)}B ({mb:.0f} MB)", file=sys.stderr)
    print("level  ours_B  zlib_B  libdeflate_B  rel_zlib  enc_MBps")
    for level in (1, 6, 7, 8, 9):
        t0 = time.perf_counter()
        ours = zf.compress(
            data, level=level, format="zlib", chunk_bytes=CHUNK_BYTES
        )
        dt = time.perf_counter() - t0
        zsize = len(zlib.compress(data, level))
        assert zlib.decompress(ours) == data, "round-trip failed"
        lsize = libdeflate_size(level)
        print(
            f"{level}  {len(ours)}  {zsize}  {lsize}  "
            f"{len(ours)/zsize:.4f}  {mb/dt:.2f}"
        )


def scaling_table(total_mib: int = 16, chunk_kib: int = 64) -> None:
    """--scaling: fixed-total-bytes encode through compress_sharded on a
    simulated CPU mesh of 1/2/4/8 devices.

    What this measures on a chip-less box: the sharding machinery's
    overhead. Total compute is constant (same bytes, same graphs) and the
    8 virtual devices share this host's cores, so the multi-chip layout
    is healthy when wall time stays FLAT as the mesh grows —
    eff_proxy(n) = T(1)/T(n), perfect = 1.0. On real chips the same
    NamedSharding layout splits that constant compute across real
    silicon (chunks are independent; XLA inserts no cross-device
    collectives in the hot path), which is what the >=80% linear-scaling
    gate (BASELINE.json:5) is about. tests/test_scaling.py gates
    eff_proxy(8) >= 0.7.
    """
    import os

    os.environ.setdefault("XLA_FLAGS", "")
    if "--xla_force_host_platform_device_count" not in os.environ["XLA_FLAGS"]:
        os.environ["XLA_FLAGS"] += " --xla_force_host_platform_device_count=8"
    import jax

    jax.config.update("jax_platforms", "cpu")

    from zzflate_tpu.parallel import sharded

    data = build_corpus(total_mib << 20)
    mb = len(data) / 1e6
    devs = jax.devices()
    rows = []
    for n in (1, 2, 4, 8):
        mesh = sharded.make_mesh(devs[:n])
        out = sharded.compress_sharded(
            data, level=LEVEL, format="gzip", mesh=mesh,
            chunk_bytes=chunk_kib << 10,
        )  # warm/compile
        assert zlib.decompress(out, wbits=31) == data
        best = 9e9
        for _ in range(3):
            t0 = time.perf_counter()
            sharded.compress_sharded(
                data, level=LEVEL, format="gzip", mesh=mesh,
                chunk_bytes=chunk_kib << 10,
            )
            best = min(best, time.perf_counter() - t0)
        rows.append((n, best, mb / best))
        print(f"devices={n} wall={best:.2f}s {mb/best:.2f} MB/s",
              file=sys.stderr, flush=True)
    t1 = rows[0][1]
    for n, t, mbps in rows:
        print(f"devices={n}  wall={t:.2f}s  MBps={mbps:.2f}  "
              f"eff_proxy={t1/t:.3f}")
    print(json.dumps({
        "metric": "scaling_eff_proxy_8dev", "value": round(t1 / rows[-1][1], 3),
        "unit": "T1/T8 (fixed total bytes, CPU mesh)",
        "vs_baseline": round((t1 / rows[-1][1]) / 0.8, 3),
    }), flush=True)


def main() -> None:
    from zzflate_tpu.utils import compile_cache

    compile_cache.enable(min_compile_secs=5)

    import zzflate_tpu as zf

    data = build_corpus()
    mb = len(data) / 1e6

    # Baseline: single-thread zlib level 6, measured now on this host.
    t0 = time.perf_counter()
    zref = zlib.compress(data, LEVEL)
    zlib_s = time.perf_counter() - t0
    zlib_mbps = mb / zlib_s

    from zzflate_tpu.utils import profiling

    # Native C engine (host serving path).
    from zzflate_tpu import native as _zn

    nat_best = 9e9
    if _zn.lib() is not None:
        nout = _zn.deflate_raw_mt(data, level=LEVEL)  # warm
        assert zlib.decompress(nout, wbits=-15) == data
        for _ in range(3):
            t0 = time.perf_counter()
            _zn.deflate_raw_mt(data, level=LEVEL)
            nat_best = min(nat_best, time.perf_counter() - t0)
    nat_mbps = round(mb / nat_best, 2) if nat_best < 9e9 else 0.0

    # Warmup / compile.
    out = zf.compress(
        data, level=LEVEL, format="gzip", chunk_bytes=CHUNK_BYTES,
        engine="tpu",
    )
    assert zlib.decompress(out, wbits=31) == data, "round-trip failed"

    times = []
    stages = None
    for _ in range(REPS):
        with profiling.collect() as timer:
            t0 = time.perf_counter()
            out = zf.compress(
                data, level=LEVEL, format="gzip", chunk_bytes=CHUNK_BYTES,
                engine="tpu",
            )
            dt = time.perf_counter() - t0
        times.append(dt)
        if stages is None or dt == min(times):
            stages = timer.as_ms()
    mbps = mb / min(times)

    print(json.dumps({
        "metric": "encode_MBps_level6", "value": round(mbps, 2),
        "unit": "MB/s", "vs_baseline": round(mbps / zlib_mbps, 3),
    }), flush=True)
    print(json.dumps({
        "metric": "encode_MBps_level6_native", "value": nat_mbps,
        "unit": "MB/s", "vs_baseline": round(nat_mbps / zlib_mbps, 3),
    }), flush=True)
    print(f"stages_ms={json.dumps(stages)}", file=sys.stderr, flush=True)

    # Native C encode engine, single-threaded (stderr detail).
    enc_native = 0.0
    if _zn.lib() is not None:
        _zn.deflate_raw(data, level=LEVEL)  # warm
        t0 = time.perf_counter()
        raw = _zn.deflate_raw(data, level=LEVEL)
        enc_native = mb / (time.perf_counter() - t0)
        assert zlib.decompress(raw, wbits=-15) == data

    # Decode-side numbers (stderr detail): native C path + device indexed
    # path, to device memory and to the host.
    t0 = time.perf_counter()
    back = zf.decompress(out, format="gzip")
    dec_native = mb / (time.perf_counter() - t0)
    assert back == data
    from zzflate_tpu.models import inflate_tpu

    oi = zf.compress(data, level=LEVEL, format="gzip",
                     chunk_bytes=CHUNK_BYTES, indexed=True)
    arr, n = inflate_tpu.decompress_indexed(oi, to_device=True)  # warm
    assert n == len(data)
    t0 = time.perf_counter()
    # Device-resident decode + on-device CRC verify (bytes never leave
    # the device).
    inflate_tpu.decompress_indexed(oi, to_device=True)
    dec_dev = mb / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    assert inflate_tpu.decompress_indexed(oi) == data
    dec_host = mb / (time.perf_counter() - t0)

    # Optional: level-9 (optimal-parse) end-to-end through the device
    # pipeline + native DP. Opt-in (ZZFLATE_BENCH_L9=1): it compiles a
    # second analyze graph.
    if _os.environ.get("ZZFLATE_BENCH_L9") == "1":
        t0 = time.perf_counter()
        o9 = zf.compress(data, level=9, format="gzip",
                         chunk_bytes=CHUNK_BYTES)
        warm9 = time.perf_counter() - t0
        assert zlib.decompress(o9, wbits=31) == data
        t0 = time.perf_counter()
        zf.compress(data, level=9, format="gzip", chunk_bytes=CHUNK_BYTES)
        enc9 = mb / (time.perf_counter() - t0)
        print(
            f"enc_l9={enc9:.2f}MB/s warm={warm9:.1f}s size9={len(o9)}B",
            file=sys.stderr, flush=True,
        )

    import jax

    dev = jax.devices()[0]
    print(
        f"device={dev.platform}:{dev.device_kind} "
        f"corpus={len(data)}B ours={len(out)}B ratio={len(data)/len(out):.3f} "
        f"zlib6={len(zref)}B ratio={len(data)/len(zref):.3f} "
        f"times={['%.2f' % t for t in times]} zlib6_enc={zlib_mbps:.1f}MB/s "
        f"enc_native={enc_native:.1f}MB/s "
        f"dec_native={dec_native:.0f}MB/s dec_dev={dec_dev:.2f}MB/s "
        f"dec_host={dec_host:.2f}MB/s",
        file=sys.stderr,
    )


if __name__ == "__main__":
    if "--full" in sys.argv:
        mib = 100
        for a in sys.argv[1:]:
            if a.startswith("--mib="):
                mib = int(a.split("=")[1])
        full_ratio_table(mib)
    elif "--scaling" in sys.argv:
        mib = 16
        for a in sys.argv[1:]:
            if a.startswith("--mib="):
                mib = int(a.split("=")[1])
        scaling_table(mib)
    else:
        main()
