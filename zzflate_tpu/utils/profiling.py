"""Tracing / profiling / metrics (SURVEY.md section 5.1 and 5.5).

The reference-class codec has wall-clock bench timing only; here:
- `trace(logdir)` wraps jax.profiler.trace for TensorBoard/Perfetto
  kernel timelines;
- `StageTimer` collects per-stage wall times; a stage that ends in
  device values can pass a `sync` callable (e.g. one that calls
  `jax.block_until_ready`) so its time includes the device work;
- `run_report(...)` emits the structured per-run JSON of section 5.5
  (bytes in/out, ratio, MB/s, per-stage ms, device info).
"""
from __future__ import annotations

import contextlib
import json
import time


@contextlib.contextmanager
def trace(logdir: str):
    """Profile a region to `logdir` (view with TensorBoard/Perfetto)."""
    import jax

    with jax.profiler.trace(logdir):
        yield


_current: "StageTimer | None" = None


@contextlib.contextmanager
def collect():
    """Activate per-stage timing for the encode pipeline.

    Usage:
        with profiling.collect() as t:
            zf.compress(...)
        print(t.as_ms())
    api._encode_segments records its phases (batch build, analyze
    dispatch+freq fetch, host Huffman planning, emit dispatch+fetch,
    stitch) into the active timer. bench.py uses this for the stages_ms
    line (SURVEY.md sections 5.1/5.5)."""
    global _current
    t = StageTimer()
    prev, _current = _current, t
    try:
        yield t
    finally:
        _current = prev


def active() -> "StageTimer | None":
    return _current


@contextlib.contextmanager
def maybe_stage(name: str):
    """Record a stage on the active collector, if any (zero-cost when off)."""
    t = _current
    if t is None:
        yield
    else:
        with t.stage(name):
            yield


class StageTimer:
    def __init__(self):
        self.stages: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        t0 = time.perf_counter()
        yield
        if sync is not None:
            sync()
        self.stages[name] = self.stages.get(name, 0.0) + (
            time.perf_counter() - t0
        )

    def as_ms(self) -> dict[str, float]:
        return {k: round(v * 1e3, 2) for k, v in self.stages.items()}


def run_report(
    op: str,
    bytes_in: int,
    bytes_out: int,
    seconds: float,
    stages: StageTimer | None = None,
    **extra,
) -> str:
    import jax

    rep = {
        "op": op,
        "device": str(jax.devices()[0]),
        "n_devices": len(jax.devices()),
        "bytes_in": bytes_in,
        "bytes_out": bytes_out,
        "ratio": round(bytes_in / max(1, bytes_out), 4),
        "seconds": round(seconds, 4),
        "MBps": round(bytes_in / 1e6 / max(seconds, 1e-9), 2),
    }
    if stages is not None:
        rep["stages_ms"] = stages.as_ms()
    rep.update(extra)
    return json.dumps(rep)
