"""Auxiliary subsystems: multi-host pipeline (single-process degenerate),
resumable sharded compression, fault-injection recovery (SURVEY.md
section 5.3/5.4/5.8)."""
import os
import zlib

import numpy as np
import pytest

from zzflate_tpu.parallel.multihost import compress_multihost
from zzflate_tpu.utils import resume

CHUNK = 4096


def _data(n=40000, seed=0):
    rng = np.random.default_rng(seed)
    text = (b"auxiliary subsystem test body " * 2000)[: n // 2]
    rnd = rng.integers(0, 256, size=n - len(text), dtype=np.uint8).tobytes()
    return text + rnd


def test_multihost_single_process_gzip():
    data = _data()
    out = compress_multihost(data, level=6, format="gzip", chunk_bytes=CHUNK)
    assert out is not None
    assert zlib.decompress(out, wbits=31) == data


def test_multihost_single_process_zlib():
    data = _data(seed=1)
    out = compress_multihost(data, level=6, format="zlib", chunk_bytes=CHUNK)
    assert zlib.decompress(out) == data


def test_resume_roundtrip(tmp_path):
    data = _data(n=100000, seed=2)
    outdir = str(tmp_path / "shards")
    m = resume.compress_to_dir(
        data, outdir, shard_bytes=32768, chunk_bytes=CHUNK
    )
    assert len(m["shards"]) == -(-len(data) // 32768)
    assert resume.missing_shards(outdir) == []
    blob = resume.assemble(outdir, format="gzip")
    assert zlib.decompress(blob, wbits=31) == data
    blob_z = resume.assemble(outdir, format="zlib")
    assert zlib.decompress(blob_z) == data


def test_resume_skips_existing_and_recovers_lost(tmp_path):
    data = _data(n=100000, seed=3)
    outdir = str(tmp_path / "shards")
    resume.compress_to_dir(data, outdir, shard_bytes=32768, chunk_bytes=CHUNK)

    # Fault injection: lose one shard's blob (SURVEY.md 5.3 — recovery is
    # re-dispatch of the failed shard only).
    lost = os.path.join(outdir, "shard_000001.seg")
    mtimes = {}
    for f in os.listdir(outdir):
        p = os.path.join(outdir, f)
        mtimes[f] = os.path.getmtime(p)
    os.remove(lost)
    # Manifest entry exists but the file is gone -> shard 1 re-encoded;
    # the others are skipped (mtimes unchanged).
    import json

    with open(os.path.join(outdir, "manifest.json")) as f:
        man = json.load(f)
    del man["shards"]["1"]
    with open(os.path.join(outdir, "manifest.json"), "w") as f:
        json.dump(man, f)
    assert resume.missing_shards(outdir) == [1]

    resume.compress_to_dir(data, outdir, shard_bytes=32768, chunk_bytes=CHUNK)
    assert resume.missing_shards(outdir) == []
    for f, t in mtimes.items():
        if f not in ("shard_000001.seg", "manifest.json"):
            assert os.path.getmtime(os.path.join(outdir, f)) == t, f
    blob = resume.assemble(outdir, format="gzip")
    assert zlib.decompress(blob, wbits=31) == data


@pytest.mark.parametrize("nprocs", [2, 3])
def test_multihost_processes(tmp_path, nprocs):
    """Real multi-process runs (jax.distributed over CPU): the distributed
    stream must be byte-identical to the single-process encode of the
    full corpus with the same chunking (BASELINE.json:11, SURVEY.md 4.6).
    3 processes exercise the uneven host-shard split and the >2-host
    gather-to-root rounds the round-4 verdict flagged as never run."""
    import socket
    import subprocess
    import sys

    import zzflate_tpu as zf

    chunk = 65536
    data = (
        open("/usr/include/zlib.h", "rb").read()
        + np.random.default_rng(5).integers(
            0, 256, size=120000, dtype=np.uint8
        ).tobytes()
    ) * 2
    corpus = tmp_path / "corpus.bin"
    corpus.write_bytes(data)
    out_file = tmp_path / "out.gz"

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"

    worker = os.path.join(os.path.dirname(__file__), "multihost_worker.py")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, worker, coord, str(nprocs), str(pid),
             str(corpus), str(chunk), str(out_file)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        )
        for pid in range(nprocs)
    ]
    errs = [p.communicate(timeout=600)[1].decode() for p in procs]
    failed = [i for i, p in enumerate(procs) if p.returncode != 0]
    assert not failed, "\n".join(
        f"--- process {i} (rc={procs[i].returncode}) stderr:\n{errs[i][-3000:]}"
        for i in range(nprocs)
    )

    blob = out_file.read_bytes()
    assert zlib.decompress(blob, wbits=31) == data
    solo = zf.compress(data, level=6, format="gzip", chunk_bytes=chunk)
    assert blob == solo, (
        f"distributed stream differs from single-process: "
        f"{len(blob)} vs {len(solo)} bytes"
    )
