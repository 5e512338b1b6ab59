"""A/B of the row-sweep parse on one GPU: CUDA kernel against XLA sweeps.

1. Device ms per production batch (16 chunks of 32 KiB halo + 256 KiB,
   L6 match lengths of `fixtures.silesia_like`) of each implementation
   alone, from a profiler trace, with the marks compared.
2. The L6 analyze graph of that batch with each parse: wall ms (median
   of --reps), device busy ms from a trace, and the idle share between
   them.
3. `zf.compress` L6 MB/s on --mib MiB of `fixtures.silesia_like`.
Steps 2 and 3 switch the parse in the order kernel, xla, xla, kernel;
each entry is the median of --reps warm runs, and the compressed
outputs must be identical.

Usage: python tools/parse_ab.py [--mib 64] [--reps 3]
       [--out chiprun_out/parse_ab]
Prints one JSON line.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tools.trace_analyze import reduce_trace  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mib", type=int, default=64)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default="chiprun_out/parse_ab")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    import zzflate_tpu as zf
    from zzflate_tpu.config import LEVELS
    from zzflate_tpu.encode_pipeline import _device_batch, build_chunk_batch
    from zzflate_tpu.models import deflate_encoder as de
    from zzflate_tpu.ops import matcher as M
    from zzflate_tpu.ops import parse_kernel
    from zzflate_tpu.utils import compile_cache, fixtures

    compile_cache.enable()
    dev = jax.devices()[0]
    assert dev.platform == "gpu", f"needs a GPU, got {dev}"
    params = LEVELS[6]
    chunk = 1 << 18
    bsz = _device_batch(chunk)
    data = fixtures.silesia_like(args.mib << 20)
    buf, vends, wstarts, _, _ = build_chunk_batch(data[: bsz * chunk], chunk,
                                                  None)
    starts = jnp.full((bsz,), 32768, jnp.int32)
    ana = de.analyze_chunks_batch(jnp.asarray(buf), starts,
                                  jnp.asarray(vends), jnp.asarray(wstarts),
                                  params)
    take = M._lazy_take(ana["mlen"], True, params.max_lazy, params.nice)
    step = jnp.where(take, jnp.maximum(ana["mlen"], 1), 1).astype(jnp.int32)
    n = step.shape[1]
    npad = -(-n // M._ROW) * M._ROW
    step = jnp.pad(step, ((0, 0), (0, npad - n)), constant_values=1)

    def parse_xla(st, sv):
        return M._parse_rows_xla(st, sv)

    def parse_cuda(st, sv):
        return parse_kernel.parse_rows(st, sv, M._ROW)

    res = {"platform": dev.platform, "device_kind": dev.device_kind,
           "batch": [bsz, npad]}
    marks = {}
    for name, fn in (("cuda", parse_cuda), ("xla", parse_xla)):
        f = jax.jit(fn)
        marks[name] = np.asarray(f(step, starts))
        wall = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            jax.block_until_ready(f(step, starts))
            wall.append(time.perf_counter() - t0)
        out = f"{args.out}_{name}"
        with jax.profiler.trace(out):
            for _ in range(args.reps):
                jax.block_until_ready(f(step, starts))
        path = sorted(glob.glob(f"{out}/plugins/profile/*/*.xplane.pb"))[-1]
        red = reduce_trace(path, f"parse_{name}", {})
        res[f"parse_{name}_device_ms"] = round(
            sum(red["ns"].values()) / 1e6 / args.reps, 4
        )
        res[f"parse_{name}_events"] = sum(red["events"].values()) // args.reps
        res[f"parse_{name}_wall_ms_median"] = round(
            statistics.median(wall) * 1e3, 4
        )
    assert np.array_equal(marks["cuda"], marks["xla"]), "marks differ"
    res["marks_identical"] = True

    impls = {"cuda": M._parse_rows, "xla": M._parse_rows_xla}
    dev_args = (jnp.asarray(buf), starts, jnp.asarray(vends),
                jnp.asarray(wstarts))
    for name in ("cuda", "xla", "xla", "cuda"):
        M._parse_rows = impls[name]
        jax.clear_caches()

        def analyze():
            return jax.block_until_ready(
                de.analyze_chunks_batch(*dev_args, params)
            )

        analyze()
        wall = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            analyze()
            wall.append(time.perf_counter() - t0)
        out = f"{args.out}_analyze_{name}"
        with jax.profiler.trace(out):
            for _ in range(args.reps):
                analyze()
        path = sorted(glob.glob(f"{out}/plugins/profile/*/*.xplane.pb"))[-1]
        red = reduce_trace(path, "analyze_chunks_batch", {})
        wall_ms = statistics.median(wall) * 1e3
        busy_ms = red["busy_ns"] / 1e6 / args.reps
        res.setdefault(f"analyze_{name}_wall_ms_median", []).append(
            round(wall_ms, 4)
        )
        res.setdefault(f"analyze_{name}_busy_ms", []).append(
            round(busy_ms, 4)
        )
        res.setdefault(f"analyze_{name}_idle_share", []).append(
            round(1 - busy_ms / wall_ms, 4)
        )

    outs = {}
    for name in ("cuda", "xla", "xla", "cuda"):
        M._parse_rows = impls[name]
        jax.clear_caches()
        blob = zf.compress(data, level=6, format="zlib")  # compile + warm
        times = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            zf.compress(data, level=6, format="zlib")
            times.append(time.perf_counter() - t0)
        outs.setdefault(name, blob)
        assert outs[name] == blob
        res.setdefault(f"encode_l6_MBps_{name}", []).append(
            round(len(data) / 1e6 / statistics.median(times), 3)
        )
    M._parse_rows = impls["cuda"]
    assert outs["cuda"] == outs["xla"], "compressed bytes differ"
    res["encode_bytes_identical"] = True
    res["in_bytes"] = len(data)
    res["out_bytes"] = len(outs["cuda"])
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
