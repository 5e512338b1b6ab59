"""Device time of the L6 analyze graph by stage, from a profiler trace.

Traces `deflate_encoder.analyze_chunks_batch` at the production batch
shape (16 chunks of 32 KiB halo + 256 KiB) and attributes every device
event of that graph to the `jax.named_scope` its HLO instruction came
from: sort, propagate, parse, or other. The neighbour scan's ops fuse
with their neighbours', so the order-B scan is traced alone, from a jit
of its own; the parse is also timed alone. Prints the bytes the scan
and propagation must move, with the floor that implies at the device's
peak HBM bandwidth (_HBM_PEAK).

Usage: python tools/trace_analyze.py [--level 6] [--reps 3] [--chunk N]
       [--per-kernel] [--out chiprun_out/trace_analyze] [--hbm-tbps T]
Prints one JSON line.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_SCOPES = ("sort", "propagate", "parse")

# Peak HBM bandwidth by device_kind, bytes/s (NVIDIA's H100 SXM data
# sheet: 3.35 TB/s). A device not listed needs --hbm-tbps.
_HBM_PEAK = {"NVIDIA H100 80GB HBM3": 3.35e12}


def scope_map(hlo_text: str) -> dict[str, str]:
    """HLO instruction name -> the first stage scope in its op_name."""
    out = {}
    pat = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?op_name=\"([^\"]*)\"")
    for line in hlo_text.splitlines():
        m = pat.match(line)
        if not m:
            continue
        parts = m.group(2).split("/")
        out[m.group(1)] = next((p for p in parts if p in _SCOPES), "other")
    return out


def reduce_trace(path: str, module: str, scopes: dict[str, str],
                 plane_prefix: str = "/device:") -> dict:
    """Device ns per scope of one HLO module's events in an xplane file
    (planes named plane_prefix...; the CPU backend's are /host:CPU)."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(path)
    per = {}
    count = {}
    unmatched = {}
    spans = []
    for plane in pd.planes:
        if not plane.name.startswith(plane_prefix):
            continue
        for line in plane.lines:
            for ev in line.events:
                st = dict(ev.stats)
                if module not in str(st.get("hlo_module", "")):
                    continue
                op = str(st.get("hlo_op", ev.name))
                sc = scopes.get(op)
                if sc is None:
                    unmatched[op] = unmatched.get(op, 0) + ev.duration_ns
                    sc = "other"
                per[sc] = per.get(sc, 0) + ev.duration_ns
                count[sc] = count.get(sc, 0) + 1
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    spans.sort()
    busy = 0.0
    end = None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    top = sorted(unmatched.items(), key=lambda kv: -kv[1])[:8]
    return {"ns": per, "events": count, "busy_ns": busy,
            "unmatched_top": top}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--level", type=int, default=6)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default="chiprun_out/trace_analyze")
    ap.add_argument("--hbm-tbps", type=float, default=None,
                    help="peak HBM TB/s for a device not in _HBM_PEAK")
    ap.add_argument("--chunk", type=int, default=1 << 18,
                    help="chunk bytes (smaller for a CPU rehearsal)")
    ap.add_argument("--per-kernel", action="store_true",
                    help="run without CUDA command buffers, so the trace "
                    "shows each kernel (a graph replay is one event)")
    args = ap.parse_args()
    if args.per_kernel:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_gpu_enable_command_buffer="
        ).strip()

    import jax
    import jax.numpy as jnp

    from zzflate_tpu.config import LEVELS
    from zzflate_tpu.encode_pipeline import _device_batch, build_chunk_batch
    from zzflate_tpu.models import deflate_encoder as de
    from zzflate_tpu.ops import matcher
    from zzflate_tpu.utils import compile_cache, fixtures

    compile_cache.enable()
    dev = jax.devices()[0]
    if args.hbm_tbps is not None:
        tbps = args.hbm_tbps * 1e12
    elif dev.device_kind in _HBM_PEAK:
        tbps = _HBM_PEAK[dev.device_kind]
    else:
        raise SystemExit(f"no HBM peak for {dev.device_kind!r}; "
                         "pass --hbm-tbps")
    params = LEVELS[args.level]
    chunk = args.chunk
    bsz = _device_batch(chunk)
    data = fixtures.silesia_like(bsz * chunk)
    buf, vends, wstarts, _, _ = build_chunk_batch(data, chunk, None)
    buf = jnp.asarray(buf)
    starts = jnp.full((bsz,), 32768, jnp.int32)
    vends = jnp.asarray(vends)
    wstarts = jnp.asarray(wstarts)
    n = buf.shape[1]

    lowered = de.analyze_chunks_batch.lower(buf, starts, vends, wstarts,
                                            params)
    compiled = lowered.compile()
    scopes = scope_map(compiled.as_text())

    def run():
        return jax.block_until_ready(
            de.analyze_chunks_batch(buf, starts, vends, wstarts, params)
        )

    ana = run()
    wall = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        run()
        wall.append(time.perf_counter() - t0)

    def parse():
        return jax.block_until_ready(matcher.parse_commit_batch(
            ana["mlen"], ana["mdist"], starts, vends,
            lazy=params.lazy_mode, max_lazy=params.max_lazy,
            nice=params.nice,
        ))

    parse()
    pwall = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        parse()
        pwall.append(time.perf_counter() - t0)

    os.makedirs(args.out, exist_ok=True)
    with jax.profiler.trace(args.out):
        for _ in range(args.reps):
            run()
    path = sorted(glob.glob(f"{args.out}/plugins/profile/*/*.xplane.pb"))[-1]
    red = reduce_trace(
        path, "analyze_chunks_batch", scopes,
        "/host:CPU" if dev.platform == "cpu" else "/device:",
    )

    # The order-B neighbour scan alone (adjacent LCPs + K-neighbour scan
    # + merge), on sorted words made by a separate jit: its fusions mix
    # with the sort's and the merge's inside the analyze graph.
    kw = params.key_words

    @jax.jit
    def sorted_b(d):
        def one(row):
            w = matcher._pack_words(row, kw)
            pos = jnp.arange(n, dtype=jnp.int32)
            out = jax.lax.sort(tuple(w) + (pos,), num_keys=kw,
                               is_stable=True)
            return jnp.stack(out[:kw]), out[kw]
        return jax.vmap(one)(d)

    @jax.jit
    def scan_only(sw, spos, ws):
        def one(w, sp, wsi):
            best, adj = matcher._scan_order(
                list(w), sp, jnp.arange(n, dtype=jnp.int32), wsi,
                jnp.zeros((n,), jnp.int32), params.candidates, 4 * kw, n,
            )
            return best, adj
        return jax.vmap(one)(sw, spos, ws)

    sw, spos = jax.block_until_ready(sorted_b(buf))
    jax.block_until_ready(scan_only(sw, spos, wstarts))
    sout = f"{args.out}_scan"
    with jax.profiler.trace(sout):
        for _ in range(args.reps):
            jax.block_until_ready(scan_only(sw, spos, wstarts))
    spath = sorted(glob.glob(f"{sout}/plugins/profile/*/*.xplane.pb"))[-1]
    sred = reduce_trace(
        spath, "scan_only", {},
        "/host:CPU" if dev.platform == "cpu" else "/device:",
    )
    scan_b_ms = sum(sred["ns"].values()) / 1e6 / args.reps

    # Bytes the scan and propagation must move at least: each reads its
    # int32 inputs once and writes its int32 outputs once. Scan: adj and
    # spos in, s_len and s_dist out, per sorted order (A and B).
    pos = bsz * n
    scan_bytes = 2 * pos * 4 * 4
    # Isolated order-B stage: kw key words + spos in, best and adj out.
    scan_b_bytes = pos * 4 * (kw + 1 + 2)
    prop_bytes = pos * 4 * 2
    reps = args.reps
    ms = {k: v / 1e6 / reps for k, v in red["ns"].items()}
    total = sum(ms.values())
    print(json.dumps({
        "platform": dev.platform, "device_kind": dev.device_kind,
        "level": args.level, "batch": [bsz, n],
        "device_ms_per_batch": {k: round(v, 4) for k, v in ms.items()},
        "device_ms_total": round(total, 4),
        "device_busy_ms": round(red["busy_ns"] / 1e6 / reps, 4),
        "events_per_batch": {
            k: v // reps for k, v in red["events"].items()
        },
        "parse_share": round(ms.get("parse", 0.0) / total, 4) if total else
        None,
        "analyze_wall_ms_median": round(statistics.median(wall) * 1e3, 3),
        "parse_alone_wall_ms_median": round(
            statistics.median(pwall) * 1e3, 3
        ),
        "scan_floor_ms": round(scan_bytes / tbps * 1e3, 4),
        "propagate_floor_ms": round(prop_bytes / tbps * 1e3, 4),
        "scan_order_b_alone_ms": round(scan_b_ms, 4),
        "scan_order_b_floor_ms": round(scan_b_bytes / tbps * 1e3, 4),
        "unmatched_top": [(k, round(v / 1e6 / reps, 4))
                          for k, v in red["unmatched_top"]],
        "trace": path,
    }), flush=True)


if __name__ == "__main__":
    main()
