"""Granular matcher sub-stage timing on the device (wall clock).

Reconstructs find_matches piece by piece at production shapes
((16, 294912), level-6 params: K=16, key_words=16) and times each
incremental graph; stage cost = difference between consecutive rows.
Prints one JSON line.
"""
from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

from zzflate_tpu.constants import WINDOW_SIZE
from zzflate_tpu.ops import matcher as M

B, N = 16, 294912
KW = 16  # key_words at level 6
K = 16   # candidates


def timeit(fn, *args, reps=3):
    out = fn(*args)
    _ = float(np.asarray(jax.tree_util.tree_leaves(out)[0]).ravel()[0])
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        _ = float(np.asarray(jax.tree_util.tree_leaves(out)[0]).ravel()[0])
        best = min(best, time.perf_counter() - t0)
    return best * 1000.0


def main():
    raw = (open("/usr/include/zlib.h", "rb").read() * 200)[: B * N]
    data = jnp.asarray(np.frombuffer(raw, np.uint8).reshape(B, N))
    ws = jnp.zeros((B,), jnp.int32)
    ve = jnp.full((B,), N, jnp.int32)

    results = {}

    import sys as _sys
    sel = [a for a in _sys.argv[1:] if not a.startswith('-')]

    def bench(name, fn, *a):
        if sel and name not in sel:
            return
        try:
            ms = timeit(fn, *a)
        except Exception as e:  # noqa: BLE001
            results[name] = f"ERR {type(e).__name__}: {e}"[:150]
            print(f"{name}: {results[name]}", file=sys.stderr)
            return
        results[name] = round(ms, 1)
        print(f"{name}: {ms:.1f} ms", file=sys.stderr)

    def red(*xs):
        return sum(jnp.sum(x.astype(jnp.int32)) for x in xs)

    # 0) floor + word packing
    @jax.jit
    def f_pack(d):
        w = jax.vmap(lambda dd: jnp.stack(M._pack_words(dd, KW)))(d)
        return red(w[:, 0, ::64])

    bench("pack_words", f_pack, data)

    # 1) + order A sort only
    @jax.jit
    def f_sortA(d):
        def one(dd):
            w = M._pack_words(dd, KW)
            pos = jnp.arange(N, dtype=jnp.int32)
            out = jax.lax.sort(tuple(w[:4]) + (pos,), num_keys=1,
                               is_stable=True)
            return out[4]
        sp = jax.vmap(one)(d)
        return red(sp[:, ::64])

    bench("sortA", f_sortA, data)

    # 2) + scan A (adj + neighbour scan + merge)
    @jax.jit
    def f_scanA(d, wsv):
        def one(dd, w_s):
            w = M._pack_words(dd, KW)
            pos = jnp.arange(N, dtype=jnp.int32)
            srank = pos
            out = jax.lax.sort(tuple(w[:4]) + (pos,), num_keys=1,
                               is_stable=True)
            bp, _ = M._scan_order(list(out[:4]), out[4], srank, w_s,
                                  jnp.zeros((N,), jnp.int32), 8, 16, N,
                                  backward_only=True)
            return bp
        bp = jax.vmap(one)(d, wsv)
        return red(bp[:, ::64])

    bench("scanA_merged", f_scanA, data, ws)

    # 3) order B sort alone
    @jax.jit
    def f_sortB(d):
        def one(dd):
            w = M._pack_words(dd, KW)
            pos = jnp.arange(N, dtype=jnp.int32)
            out = jax.lax.sort(tuple(w) + (pos,), num_keys=KW,
                               is_stable=True)
            return out[KW]
        sp = jax.vmap(one)(d)
        return red(sp[:, ::64])

    bench("sortB", f_sortB, data)

    # 4) + adjB (16-word LCP of sort-neighbors)
    @jax.jit
    def f_adjB(d):
        def one(dd):
            w = M._pack_words(dd, KW)
            pos = jnp.arange(N, dtype=jnp.int32)
            out = jax.lax.sort(tuple(w) + (pos,), num_keys=KW,
                               is_stable=True)
            sw = list(out[:KW])
            adj = M._lcp_words([jnp.roll(v, 1) for v in sw], sw)
            return adj.at[0].set(0)
        adj = jax.vmap(one)(d)
        return red(adj[:, ::64])

    bench("adjB", f_adjB, data)

    # 5) + scan B merged
    @jax.jit
    def f_scanB(d, wsv):
        def one(dd, w_s):
            w = M._pack_words(dd, KW)
            pos = jnp.arange(N, dtype=jnp.int32)
            out = jax.lax.sort(tuple(w) + (pos,), num_keys=KW,
                               is_stable=True)
            bp, adj = M._scan_order(list(out[:KW]), out[KW], pos, w_s,
                                    jnp.zeros((N,), jnp.int32), K, 4 * KW, N)
            return bp, adj, out[KW]
        bp, adj, sp = jax.vmap(one)(d, wsv)
        return red(bp[:, ::64], adj[:, ::64])

    bench("scanB_merged", f_scanB, data, ws)

    # 6) rank_of x3 (scatters) on top of 5
    @jax.jit
    def f_ranks(d, wsv):
        def one(dd, w_s):
            w = M._pack_words(dd, KW)
            pos = jnp.arange(N, dtype=jnp.int32)
            out = jax.lax.sort(tuple(w) + (pos,), num_keys=KW,
                               is_stable=True)
            bp, adj = M._scan_order(list(out[:KW]), out[KW], pos, w_s,
                                    jnp.zeros((N,), jnp.int32), K, 4 * KW, N)
            sposB = out[KW]
            ranks = []
            width = 16
            while width <= 4 * KW:
                change = (adj < width).astype(jnp.int32)
                rs = jnp.cumsum(change)
                ranks.append(jnp.zeros((N,), jnp.int32).at[sposB].set(rs))
                width *= 2
            return bp, ranks[-1]
        bp, rk = jax.vmap(one)(d, wsv)
        return red(bp[:, ::64], rk[:, ::64])

    bench("plus_ranks", f_ranks, data, ws)

    # 6b) isolated: propagation XLA vs Pallas on a realistic packed array
    rng0 = np.random.default_rng(0)
    mlen0 = rng0.integers(3, 259, size=(B, N)).astype(np.int32)
    mlen0 = np.where(rng0.random((B, N)) < 0.6, 0, mlen0)
    mdist0 = rng0.integers(1, 32769, size=(B, N)).astype(np.int32)
    pk0 = jnp.asarray(
        np.where(mlen0 > 0, (mlen0 << 15) | (WINDOW_SIZE - mdist0), 0),
        jnp.int32,
    )

    @jax.jit
    def f_prop_xla(pk):
        return red(jax.vmap(M._propagate)(pk)[:, ::64])

    bench("prop_xla", f_prop_xla, pk0)

    # 6c) isolated: the block-rank extension ladder's gather pattern
    @jax.jit
    def f_ext_gathers(pk):
        rk = pk  # stand-in rank array, same shape/dtype
        nq = N // 16
        posx = jnp.arange(nq, dtype=jnp.int32) * 16
        def one(r1):
            acc = jnp.zeros((nq,), jnp.int32)
            for k in range(1, 20):
                acc = acc + jnp.take(r1, posx + 64 * k, mode="clip")
            return acc
        return red(jax.vmap(one)(pk)[:, ::64])

    bench("ext_gathers19", f_ext_gathers, pk0)

    # 7) full find_matches (everything incl. extension + propagation)
    @jax.jit
    def f_full(d, vev, wsv):
        ml, md = jax.vmap(
            lambda dd, v, w_s: M.find_matches(dd, v, w_s, K, key_words=KW)
        )(d, vev, wsv)
        return red(ml[:, ::64], md[:, ::64])

    bench("full", f_full, data, ve, ws)

    env = {k: v for k, v in os.environ.items() if k.startswith("ZZFLATE")}
    print(json.dumps({"B": B, "N": N, "env": env, "results": results}))


if __name__ == "__main__":
    main()
