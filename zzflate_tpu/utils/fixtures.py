"""Deterministic Silesia-like benchmark fixture (SURVEY.md §4, VERDICT #8).

The real Silesia corpus is not on this box, so this builds a ~100 MiB
stand-in with the same character: mixed text (C headers), structured
records (XML-ish), binary code (ELF shared objects), and precompressed
data (gzip members, which must hit the stored fallback). Deterministic
given this filesystem: file lists are sorted, synthetic parts are seeded,
and the slice layout is fixed, so ratio numbers are comparable across
rounds on the same box (BASELINE.md records them).
"""
from __future__ import annotations

import glob
import gzip
import io

import numpy as np

_MIB = 1 << 20


def _read_sorted(pattern: str, budget: int) -> bytes:
    parts = []
    total = 0
    for path in sorted(glob.glob(pattern)):
        try:
            b = open(path, "rb").read()
        except OSError:
            continue
        parts.append(b)
        total += len(b)
        if total >= budget:
            break
    return b"".join(parts)[:budget]


def _xmlish(budget: int) -> bytes:
    rng = np.random.default_rng(20260817)
    ids = rng.integers(0, 10**9, size=budget // 60 + 1)
    out = io.StringIO()
    for i in ids:
        out.write(
            f"<row id='{i}' v='{i % 997}'><name>item-{i % 5000}</name>"
            f"<flag>{'y' if i % 3 else 'n'}</flag></row>\n"
        )
        if out.tell() >= budget:
            break
    return out.getvalue().encode()[:budget]


def seeded_mix(target: int, seed: int = 0) -> bytes:
    """Mixed corpus of exactly `target` bytes made from `seed` alone.

    Unlike silesia_like it reads no host files, so its bytes (and the
    codec's output on it) are the same on every machine: a third
    XML-ish records, a third seeded random bytes (stored-fallback food),
    and a third a repeated block of seeded pseudo-words.
    """
    rng = np.random.default_rng(seed)
    third = target // 3
    xml = _xmlish(third)
    rand = rng.integers(0, 256, size=third, dtype=np.uint8).tobytes()
    vocab = [
        bytes(rng.integers(97, 123, size=int(k), dtype=np.uint8))
        for k in rng.integers(2, 10, size=400)
    ]
    words = rng.integers(0, len(vocab), size=4096)
    block = b" ".join(vocab[i] for i in words) + b".\n"
    rest = target - len(xml) - len(rand)
    text = (block * (rest // len(block) + 1))[:rest]
    return xml + rand + text


def silesia_like(target: int = 100 * _MIB) -> bytes:
    """Deterministic mixed corpus of ~`target` bytes.

    Layout (by quarter): text headers / XML records / ELF binaries /
    a mix of precompressed gzip + pseudo-random (stored-fallback food).
    """
    q = target // 4
    text = _read_sorted("/usr/include/**/*.h", q) or b"x" * q
    if len(text) < q:
        text = (text * (q // max(1, len(text)) + 1))[:q]
    xml = _xmlish(q)
    elf = _read_sorted("/usr/lib/x86_64-linux-gnu/lib*.so*", q)
    if len(elf) < q:
        elf = (elf * (q // max(1, len(elf)) + 1))[:q]
    pre = gzip.compress(text[: q // 2], 6, mtime=0)
    rng = np.random.default_rng(4242)
    rand = rng.integers(
        0, 256, size=max(0, q - len(pre)), dtype=np.uint8
    ).tobytes()
    blob = (text + xml + elf + pre + rand)[:target]
    if len(blob) < target:
        blob = (blob * (target // max(1, len(blob)) + 1))[:target]
    return blob
