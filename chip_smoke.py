#!/usr/bin/env python3
"""Smoke run of the codec's device pipeline on one GPU.

    python chip_smoke.py            # every phase on one card
    python chip_smoke.py --cards 4  # only compress_sharded on four cards
    python chip_smoke.py --mib 4    # shrink the large inputs (rehearsal)

Phases (one card): device, parse_kernel, bitexact, encode,
decode_indexed, decode_foreign, range_stream; (--cards 4): parse_kernel
on every card, sharded. Each prints one JSON line
naming the card; any failure raises, so the exit code is nonzero and no
result line is printed. The last line of a successful run is
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.

This is a smoke test, not a benchmark: its seconds include compilation
(cold) and one repeat (warm), and are not medians.
"""
from __future__ import annotations

import argparse
import faulthandler
import json
import os
import subprocess
import sys
import time
import zlib

_MIB = 1 << 20
_WIN = 32768


def _card() -> str:
    """`name, power.limit` of the card as nvidia-smi reports it."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip().splitlines()[0]


class Smoke:
    def __init__(self, args):
        import jax

        from zzflate_tpu.utils import compile_cache

        dev = jax.devices()[0]
        if dev.platform != "gpu":
            raise SystemExit(
                f"chip_smoke needs a GPU; JAX's first device is {dev}"
            )
        self.cache = compile_cache.enable()
        self.args = args
        self.platform = dev.platform
        self.kind = dev.device_kind
        self.card = _card()
        print(self.card, flush=True)

    def emit(self, phase: str, **fields) -> None:
        rec = {
            "phase": phase, "platform": self.platform,
            "device_kind": self.kind, "card": self.card,
        }
        rec.update(fields)
        print(json.dumps(rec), flush=True)

    @staticmethod
    def timed(fn):
        """(result, cold seconds, warm seconds) of two calls of fn."""
        t0 = time.perf_counter()
        out = fn()
        cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        again = fn()
        warm = time.perf_counter() - t0
        if isinstance(out, bytes):
            assert again == out, "two runs of one input differ"
        return out, round(cold, 3), round(warm, 3)

    # -- phases -----------------------------------------------------------

    def device(self) -> None:
        import jax
        import jax.numpy as jnp
        import numpy as np

        from zzflate_tpu import native
        from zzflate_tpu.config import LEVELS
        from zzflate_tpu.encode_pipeline import _device_batch
        from zzflate_tpu.models import deflate_encoder as de
        from zzflate_tpu.ops import huffman_host, parse_kernel

        assert native.lib() is not None, "native library did not build"
        t0 = time.perf_counter()
        parse_kernel.ensure_registered()
        t_build = time.perf_counter() - t0
        chunk = 1 << 18
        bsz = _device_batch(chunk)
        n = _WIN + chunk
        args = (
            jax.ShapeDtypeStruct((bsz, n), jnp.uint8),
            jax.ShapeDtypeStruct((bsz,), jnp.int32),
            jax.ShapeDtypeStruct((bsz,), jnp.int32),
            jax.ShapeDtypeStruct((bsz,), jnp.int32),
        )
        t0 = time.perf_counter()
        ana = de.analyze_chunks_batch.lower(*args, LEVELS[6]).compile()
        t_ana = time.perf_counter() - t0
        outs = jax.eval_shape(
            lambda *a: de.analyze_chunks_batch(*a, LEVELS[6]), *args
        )
        sub = {
            k: outs[k] for k in (
                "committed", "is_match", "litlen_sym", "lcode", "dcode",
                "mlen", "mdist",
            )
        }
        sb = outs["freqs"].shape[1]
        plan = huffman_host.build_chunk_plan(
            np.ones((sb, 288), np.int64), np.ones((sb, 30), np.int64),
            bfinal=0,
        )
        tables = [
            jax.ShapeDtypeStruct((bsz,) + np.shape(plan[k]), dt)
            for k, dt in (
                ("ll_len", jnp.int32), ("ll_code", jnp.uint32),
                ("d_len", jnp.int32), ("d_code", jnp.uint32),
                ("hdr_vals", jnp.uint32), ("hdr_nbits", jnp.int32),
                ("eob_v", jnp.uint32), ("eob_nb", jnp.int32),
            )
        ]
        t0 = time.perf_counter()
        emit = de.emit_chunks_batch.lower(
            sub, de.output_words_bound(chunk), *tables, compact=True,
            token_slots=de.token_budget(chunk),
        ).compile()
        t_emit = time.perf_counter() - t0

        def mem(c):
            m = c.memory_analysis()
            return {
                k: int(getattr(m, k)) for k in (
                    "argument_size_in_bytes", "output_size_in_bytes",
                    "temp_size_in_bytes", "generated_code_size_in_bytes",
                )
            }

        self.emit(
            "device", batch=[bsz, n], native_lib=True,
            parse_kernel_build_s=round(t_build, 3),
            compile_cache=self.cache,
            analyze_l6=dict(mem(ana), compile_s=round(t_ana, 3)),
            emit_l6=dict(mem(emit), compile_s=round(t_emit, 3)),
        )

    def parse_kernel(self, cards: int = 1) -> None:
        """Runs a test marked `gpu` (the CUDA parse kernel against the
        XLA sweeps, on one card or on each of several), which skips under
        pytest's CPU-only settings."""
        import importlib.util

        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "tests", "test_parse_kernel.py")
        spec = importlib.util.spec_from_file_location("_gpu_tests", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        t0 = time.perf_counter()
        if cards == 1:
            mod.test_kernel_matches_xla_sweeps_on_gpu()
        else:
            mod.test_kernel_on_every_card()
        self.emit(
            "parse_kernel", cards=cards, identical_to_xla=True,
            seconds=round(time.perf_counter() - t0, 3),
        )

    def bitexact(self) -> None:
        import hashlib

        import jax

        import zzflate_tpu as zf
        from zzflate_tpu.utils import fixtures

        data = fixtures.seeded_mix(4 * _MIB, seed=0)
        cases = {
            "L1": dict(level=1, format="zlib"),
            "L6": dict(level=6, format="zlib"),
            "L9": dict(level=9, format="zlib"),
            "L6_indexed": dict(level=6, format="gzip", indexed=True),
        }
        cpu = jax.devices("cpu")[0]
        digests = {}
        t0 = time.perf_counter()
        for name, kw in cases.items():
            gpu_out = zf.compress(data, **kw)
            with jax.default_device(cpu):
                cpu_out = zf.compress(data, **kw)
            assert gpu_out == cpu_out, f"{name}: GPU and CPU bytes differ"
            wbits = 31 if kw["format"] == "gzip" else 15
            assert zlib.decompress(gpu_out, wbits) == data, name
            digests[name] = [len(gpu_out),
                             hashlib.sha256(gpu_out).hexdigest()[:16]]
        self.emit(
            "bitexact", in_bytes=len(data), identical=True,
            out=digests, seconds=round(time.perf_counter() - t0, 3),
        )

    def encode(self) -> None:
        import zzflate_tpu as zf
        from zzflate_tpu.utils import fixtures

        big = fixtures.silesia_like(self.args.mib * _MIB)
        self.big = big
        for level, data in ((6, big), (1, big[: len(big) // 4]),
                            (9, big[: len(big) // 4])):
            out, cold, warm = self.timed(
                lambda: zf.compress(data, level=level, format="zlib")
            )
            assert zlib.decompress(out) == data, f"L{level} round trip"
            zsize = len(zlib.compress(data, level))
            self.emit(
                "encode", level=level, in_bytes=len(data),
                out_bytes=len(out), rel_zlib=round(len(out) / zsize, 5),
                cold_s=cold, warm_s=warm,
                MBps_warm=round(len(data) / 1e6 / warm, 3),
            )

    def decode_indexed(self) -> None:
        import numpy as np

        import zzflate_tpu as zf
        from zzflate_tpu.models import inflate_tpu

        data = self.big
        blob = zf.compress(data, level=6, format="gzip", indexed=True)
        zsize = len(zlib.compress(data, 6))

        def to_device():
            arr, n = inflate_tpu.decompress_indexed(blob, to_device=True)
            arr.block_until_ready()
            return arr, n

        (arr, n), cold, warm = self.timed(to_device)
        assert n == len(data), "device decode length"
        assert np.asarray(arr[:n]).tobytes() == data, "device decode bytes"
        self.emit(
            "decode_indexed", to_device=True, in_bytes=len(blob),
            out_bytes=n, rel_zlib=round(len(blob) / zsize, 5),
            cold_s=cold, warm_s=warm,
        )
        out, cold, warm = self.timed(
            lambda: inflate_tpu.decompress_indexed(blob)
        )
        assert out is not None and out == data, "host decode bytes"
        self.emit(
            "decode_indexed", to_device=False, in_bytes=len(blob),
            out_bytes=len(out), rel_zlib=round(len(blob) / zsize, 5),
            cold_s=cold, warm_s=warm,
        )

    def decode_foreign(self) -> None:
        from zzflate_tpu.models import inflate_tpu

        data = self.big[: len(self.big) // 4]
        blob = zlib.compress(data, 6)
        out, cold, warm = self.timed(
            lambda: inflate_tpu.decompress_foreign(blob, format="zlib")
        )
        assert out is not None and out == data, "foreign decode"
        self.emit(
            "decode_foreign", in_bytes=len(blob), out_bytes=len(out),
            rel_zlib=1.0, cold_s=cold, warm_s=warm,
        )

    def range_stream(self) -> None:
        import zzflate_tpu as zf
        from zzflate_tpu import stream

        data = self.big[: len(self.big) // 4]
        blob, cold, warm = self.timed(
            lambda: zf.compress(data, level=6, format="gzip", indexed=True,
                                seekable=True)
        )
        assert zlib.decompress(blob, 31) == data, "seekable round trip"
        n = len(data)
        for off, ln in ((0, 1000), (n // 2 - 77, min(300_000, n // 3)),
                        (n - 4096, 4096)):
            got = zf.decompress_range(blob, off, ln)
            assert got == data[off : off + ln], f"range {off}+{ln}"
        self.emit(
            "range_stream", kind="seekable", in_bytes=n,
            out_bytes=len(blob),
            rel_zlib=round(len(blob) / len(zlib.compress(data, 6)), 5),
            cold_s=cold, warm_s=warm, ranges=3,
        )

        part = data[: 4 * _MIB]
        step = 64 << 10

        def flushed():
            c = stream.Compressor(level=6, format="zlib")
            pieces = []
            for i in range(0, len(part), step):
                pieces.append(c.compress(part[i : i + step]))
                pieces.append(c.flush(stream.Z_SYNC_FLUSH))
            pieces.append(c.flush(stream.Z_FINISH))
            return b"".join(pieces)

        out, cold, warm = self.timed(flushed)
        assert zlib.decompress(out) == part, "sync-flush stream"
        self.emit(
            "range_stream", kind="sync_flush_64KiB", in_bytes=len(part),
            out_bytes=len(out),
            rel_zlib=round(len(out) / len(zlib.compress(part, 6)), 5),
            cold_s=cold, warm_s=warm,
        )

    def sharded(self, cards: int) -> None:
        import jax

        import zzflate_tpu as zf
        from zzflate_tpu.parallel import sharded
        from zzflate_tpu.utils import fixtures

        devs = jax.devices()
        assert len(devs) >= cards, f"need {cards} cards, have {len(devs)}"
        self.parse_kernel(len(devs))
        mesh = sharded.make_mesh(devs[:cards])
        data = fixtures.silesia_like(self.args.mib * _MIB)
        zsize = len(zlib.compress(data, 6))
        for kw in ({}, {"indexed": True, "seekable": True}):
            out, cold, warm = self.timed(
                lambda: sharded.compress_sharded(
                    data, level=6, format="gzip", mesh=mesh, **kw
                )
            )
            solo = zf.compress(data, level=6, format="gzip", **kw)
            assert out == solo, "sharded stream differs from one card's"
            assert zlib.decompress(out, 31) == data, "sharded round trip"
            if kw:
                off = len(data) // 3
                assert zf.decompress_range(out, off, 5000) == \
                    data[off : off + 5000], "sharded range read"
            self.emit(
                "sharded", cards=cards, in_bytes=len(data),
                out_bytes=len(out), rel_zlib=round(len(out) / zsize, 5),
                identical_to_one_card=True, cold_s=cold, warm_s=warm, **kw,
            )


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4 runs only compress_sharded across four cards")
    ap.add_argument("--mib", type=int, default=64,
                    help="size of the large input in MiB (default 64)")
    ap.add_argument("--deadline-s", type=int, default=1000,
                    help="after this many seconds, print every thread's "
                    "stack and exit 1 (default 1000)")
    args = ap.parse_args()
    faulthandler.dump_traceback_later(args.deadline_s, exit=True)

    s = Smoke(args)
    if args.cards == 1:
        s.device()
        s.parse_kernel()
        s.bitexact()
        s.encode()
        s.decode_indexed()
        s.decode_foreign()
        s.range_stream()
    else:
        s.sharded(args.cards)

    print(json.dumps({
        "ok": True,
        "device": {
            "platform": s.platform, "kind": s.kind, "count": args.cards,
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
