"""Ratio sensitivity of matcher knobs (CPU; sizes are platform-independent).

Patches config.LEVELS[--level] with (candidates, key_words) variants and
compresses two fixtures, printing compressed sizes vs zlib.

Usage: python tools/ratio_ablate.py [--level 6] [--mib 2] [variants...]
  variant syntax: K<candidates>w<key_words>  e.g. k16w16 k16w8 k12w4
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import zlib

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--level", type=int, default=6)
    ap.add_argument("--mib", type=int, default=2)
    ap.add_argument("variants", nargs="*",
                    default=["k16w16", "k16w8", "k16w4", "k24w8"])
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    from zzflate_tpu.utils import compile_cache
    compile_cache.enable()

    from zzflate_tpu import api, config
    from zzflate_tpu.utils import fixtures

    tgt = args.mib << 20
    zh = open("/usr/include/zlib.h", "rb").read()
    corp = {
        "zlibh_rep": (zh * (tgt // len(zh) + 1))[:tgt],
        "silesia2": fixtures.silesia_like(tgt),
    }
    zsizes = {k: len(zlib.compress(v, args.level)) for k, v in corp.items()}
    print(f"zlib L{args.level}: " + " ".join(
        f"{k}={v}" for k, v in zsizes.items()), flush=True)

    base = config.LEVELS[args.level]
    for var in args.variants:
        k, w = var[1:].split("w")
        params = dataclasses.replace(
            base, candidates=int(k), key_words=int(w)
        )
        config.LEVELS[args.level] = params
        import time
        row = []
        for name, data in corp.items():
            t0 = time.perf_counter()
            out = api.compress(data, level=args.level, format="zlib")
            dt = time.perf_counter() - t0
            assert zlib.decompress(out) == data
            row.append(
                f"{name}={len(out)} ({len(out)/zsizes[name]:.4f}) {dt:.0f}s"
            )
        print(f"{var}: " + "  ".join(row), flush=True)
    config.LEVELS[args.level] = base


if __name__ == "__main__":
    main()
