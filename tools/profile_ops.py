"""Per-op cost measurement on the device (forced-fetch timing).

Every timing ends in a scalar fetch, so it includes the device work.
Each op runs K times inside ONE jitted fori_loop with a data dependency
threaded through (so XLA cannot hoist the op out of the loop); per-op
time = (total - floor) / K. Results print as one JSON dict.

Usage: python tools/profile_ops.py [--n 294912] [--k 8] [ops...]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax


def fetch(x) -> float:
    return float(np.asarray(jax.tree_util.tree_leaves(x)[0]).ravel()[0])


def time_chained(step, init_state, k: int, warm: int = 1):
    """step: state -> state. Runs k iterations inside one jit; returns ms/iter."""

    @jax.jit
    def run(state):
        return lax.fori_loop(0, k, lambda i, s: step(s, i), state)

    out = run(init_state)  # compile + warm
    fetch(out)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        out = run(init_state)
        fetch(out)
        best = min(best, time.perf_counter() - t0)
    return best * 1000.0 / k


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=294912)  # 32K halo + 256K chunk
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("ops", nargs="*")
    args = ap.parse_args()
    n, k = args.n, args.k

    rng = np.random.default_rng(0)
    u32 = jnp.asarray(rng.integers(0, 1 << 32, size=n, dtype=np.uint32))
    i32 = jnp.asarray(rng.integers(0, n, size=n, dtype=np.int32))
    f32 = jnp.asarray(rng.random(n, dtype=np.float32))

    results = {}

    def bench(name, step, init):
        if args.ops and name not in args.ops:
            return
        try:
            ms = time_chained(step, init, k)
        except Exception as e:  # noqa: BLE001
            results[name] = f"ERR {type(e).__name__}: {e}"[:120]
            print(f"{name}: {results[name]}", file=sys.stderr)
            return
        results[name] = round(ms, 3)
        print(f"{name}: {ms:.3f} ms", file=sys.stderr)

    # --- floor: empty loop ---
    bench("floor_noop", lambda s, i: s + 1, jnp.int32(0))

    # --- elementwise pass ---
    bench("elementwise", lambda s, i: s * 3 + 1, u32)

    # --- roll ---
    bench("roll", lambda s, i: jnp.roll(s, 1) + 1, u32)

    # --- cumsum ---
    bench("cumsum_i32", lambda s, i: jnp.cumsum(s & 1, dtype=jnp.int32) + i,
          i32)

    # --- associative scan max ---
    bench("scan_max", lambda s, i: lax.associative_scan(jnp.maximum, s) - i,
          i32)

    # --- sort 1 key u32 ---
    bench("sort_u32", lambda s, i: jnp.sort(s ^ i.astype(jnp.uint32)), u32)

    # --- argsort 1 key ---
    def _argsort_step(s, i):
        keys, _ = s
        order = jnp.argsort(keys ^ i.astype(jnp.uint32))
        return keys, order.astype(jnp.int32)
    bench("argsort_u32", _argsort_step, (u32, i32))

    # --- lexsort 2 keys ---
    def _lex2(s, i):
        k0, k1 = s
        order = jnp.lexsort((k1, k0 ^ i.astype(jnp.uint32)))
        return k0, jnp.take(k1, order)
    bench("lexsort2_plus_take", _lex2, (u32, jnp.roll(u32, 7)))

    # --- lexsort 4 keys ---
    def _lex4(s, i):
        k0, k1, k2, k3 = s
        order = jnp.lexsort((k3, k2, k1, k0 ^ i.astype(jnp.uint32)))
        return k0, k1, k2, jnp.take(k3, order)
    bench("lexsort4_plus_take", _lex4,
          (u32, jnp.roll(u32, 3), jnp.roll(u32, 5), jnp.roll(u32, 7)))

    # --- variadic sort with 4 payloads (lax.sort carries payloads) ---
    def _vsort(s, i):
        k0, p1, p2, p3, p4 = s
        out = lax.sort((k0 ^ i.astype(jnp.uint32), p1, p2, p3, p4),
                       num_keys=1)
        return out
    bench("sort_1key_4payload", _vsort,
          (u32, u32, u32, i32, i32))

    def _vsort2(s, i):
        k0, k1, p1, p2, p3 = s
        out = lax.sort((k0 ^ i.astype(jnp.uint32), k1, p1, p2, p3),
                       num_keys=2)
        return out
    bench("sort_2key_3payload", _vsort2,
          (u32, jnp.roll(u32, 3), u32, i32, i32))

    # --- random gather N ---
    def _gather(s, i):
        vals, idx = s
        g = jnp.take(vals, (idx + i) & (n - 1) if (n & (n - 1)) == 0
                     else (idx + i) % n)
        return g, idx
    bench("gather_random", _gather, (i32, i32))

    # --- chained gather g[g] (parse_commit inner) ---
    def _gg(s, i):
        g = s
        g = jnp.clip(g[g] + (i & 0), 0, n - 1)
        return g
    bench("gather_gg", _gg, jnp.clip(i32, 0, n - 1))

    # --- scatter set unique (permutation) ---
    perm = jnp.asarray(rng.permutation(n).astype(np.int32))
    def _scat_u(s, i):
        vals, p = s
        out = jnp.zeros((n,), jnp.int32).at[p].set(vals + i)
        return out, p
    bench("scatter_unique_set", _scat_u, (i32, perm))

    # --- scatter max random (parse_commit reach) ---
    def _scat_m(s, i):
        vals, idx = s
        out = jnp.zeros((n,), jnp.int32).at[idx].max(vals + i)
        return out, idx
    bench("scatter_max_random", _scat_m, (i32, i32))

    # --- scatter add random ---
    def _scat_a(s, i):
        vals, idx = s
        out = jnp.zeros((n,), jnp.int32).at[idx].add(vals + i)
        return out, idx
    bench("scatter_add_random", _scat_a, (i32, i32))

    # --- histogram comparison-reduce 288 syms (current approach, 1 subblock) ---
    def _hist_cmp(s, i):
        syms = s
        sym_ids = jnp.arange(288, dtype=jnp.int32)
        h = jnp.sum(
            (syms[None, :] == sym_ids[:, None]).astype(jnp.int32), axis=1
        )
        return syms + (h[0] & 0)
    bench("hist288_compare", _hist_cmp, i32 % 288)

    # --- histogram via sort + searchsorted ---
    def _hist_sort(s, i):
        syms = s
        ss = jnp.sort(syms + (i & 0))
        edges = jnp.searchsorted(ss, jnp.arange(289, dtype=jnp.int32))
        h = jnp.diff(edges)
        return syms + (h[0] & 0)
    bench("hist288_sort", _hist_sort, i32 % 288)

    # --- bincount-style scatter-add histogram ---
    def _hist_scat(s, i):
        syms = s
        h = jnp.zeros((288,), jnp.int32).at[syms].add(1 + (i & 0))
        return syms + (h[0] & 0)
    bench("hist288_scatter", _hist_scat, i32 % 288)

    # --- one-hot int8 matmul histogram (MXU) ---
    def _hist_mm(s, i):
        syms = s
        oh = (syms[:, None] == jnp.arange(288, dtype=jnp.int32)[None, :])
        h = jnp.matmul(
            jnp.ones((1, n), jnp.int8), oh.astype(jnp.int8),
            preferred_element_type=jnp.int32,
        )[0]
        return syms + (h[0] & 0)
    bench("hist288_matmul_i8", _hist_mm, i32 % 288)

    # --- scaling probe: same ops at 4x and 16x N (is cost latency-bound?) ---
    for mult in (4, 16):
        if args.ops and not any(o.endswith(f"x{mult}") for o in args.ops):
            if args.ops:
                continue
        nn = n * mult
        rngm = np.random.default_rng(mult)
        u32m = jnp.asarray(
            rngm.integers(0, 1 << 32, size=nn, dtype=np.uint32)
        )
        i32m = jnp.asarray(rngm.integers(0, nn, size=nn, dtype=np.int32))
        bench(f"elementwise_x{mult}", lambda s, i: s * 3 + 1, u32m)
        bench(f"sort_u32_x{mult}",
              lambda s, i: jnp.sort(s ^ i.astype(jnp.uint32)), u32m)

        def _gatherm(s, i, nn=nn):
            vals, idx = s
            g = jnp.take(vals, (idx + i) % nn)
            return g, idx
        bench(f"gather_random_x{mult}", _gatherm, (i32m, i32m))

        def _scatmm(s, i, nn=nn):
            vals, idx = s
            out = jnp.zeros((nn,), jnp.int32).at[idx].max(vals + i)
            return out, idx
        bench(f"scatter_max_x{mult}", _scatmm, (i32m, i32m))

    # --- pipeline stages on real shapes ---
    from zzflate_tpu.ops import matcher
    from zzflate_tpu.config import LEVELS

    data_np = (open("/usr/include/zlib.h", "rb").read() * 40)[:n]
    data = jnp.asarray(np.frombuffer(data_np, np.uint8))
    ve = jnp.int32(n)
    ws = jnp.int32(0)

    def _match_step(s, i):
        d = s
        ml, md = matcher.find_matches(d, ve, ws, 16)
        return d ^ (ml[0] & 0).astype(jnp.uint8)
    bench("stage_find_matches_k16", _match_step, data)

    ml, md = jax.jit(matcher.find_matches, static_argnames=("candidates",))(
        data, ve, ws, 16
    )
    ml = jax.block_until_ready(ml)

    def _parse_step(s, i):
        l, d = s
        com, take = matcher.parse_commit(l, d, jnp.int32(0), ve, lazy=True)
        return l + (com[0] & 0), d
    bench("stage_parse_commit", _parse_step, (ml, md))

    print(json.dumps({"n": n, "k": k, "backend": jax.default_backend(),
                      "results": results}))


if __name__ == "__main__":
    main()
