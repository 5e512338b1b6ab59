"""The CUDA row-sweep parse (ops/parse_kernel.py): its dispatch and
shapes on the CPU, and its marks against the XLA sweeps on a GPU."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from zzflate_tpu.ops import matcher as M
from zzflate_tpu.ops import parse_kernel


def _batch(b, n, seed=7, density=0.3):
    rng = np.random.default_rng(seed)
    mlen = np.where(
        rng.random((b, n)) < density, rng.integers(3, 259, (b, n)), 0
    ).astype(np.int32)
    mdist = np.where(mlen > 0, rng.integers(1, 1000, (b, n)), 0)
    starts = rng.integers(0, min(n, 40000), b).astype(np.int32)
    return (jnp.asarray(mlen), jnp.asarray(mdist.astype(np.int32)),
            jnp.asarray(starts), jnp.full((b,), n, jnp.int32))


def _lower(platform, b=3, n=2048 + 123):
    return M.parse_commit_batch.trace(*_batch(b, n), lazy=True).lower(
        lowering_platforms=(platform,)
    ).as_text()


def test_cpu_lowering_runs_xla_sweeps():
    text = _lower("cpu")
    assert parse_kernel.TARGET not in text
    assert "while" in text


def test_cuda_lowering_calls_kernel_on_padded_rows():
    # 2171 positions pad to 5 rows of 512; the kernel sees (3, 2560).
    text = _lower("cuda")
    calls = [l for l in text.splitlines() if parse_kernel.TARGET in l]
    assert len(calls) == 1
    assert f"row = {M._ROW} : i64" in calls[0]
    npad = -(-2171 // M._ROW) * M._ROW
    assert f"tensor<3x{npad}xi32>" in calls[0]
    assert "stablehlo.while" not in text


def test_other_platform_is_an_error():
    with pytest.raises(NotImplementedError):
        _lower("rocm")


@pytest.mark.gpu
def test_kernel_matches_xla_sweeps_on_gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: the CUDA kernel has no interpret mode")
    xla = jax.jit(M._parse_rows_xla)
    cuda = jax.jit(lambda s, st: parse_kernel.parse_rows(s, st, M._ROW))
    for b, n, seed, density in ((3, 2560, 7, 0.3), (16, 294912, 1, 0.25),
                                (2, 1024, 3, 0.9)):
        mlen, _, starts, _ = _batch(b, n, seed, density)
        step = jnp.where(mlen >= 3, mlen, 1).astype(jnp.int32)
        want = np.asarray(xla(step, starts))
        got = np.asarray(cuda(step, starts))
        assert np.array_equal(got, want), (b, n)
        assert want.sum() > 0


@pytest.mark.gpu
def test_kernel_on_every_card():
    # Each card runs the kernel on its own rows (shard_map), as
    # compress_sharded does; each card's marks equal the XLA sweeps'.
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if len(gpus) < 2:
        pytest.skip("needs two or more GPUs")
    mesh = Mesh(np.asarray(gpus), ("rows",))
    rows = NamedSharding(mesh, PartitionSpec("rows"))
    per_card = jax.jit(jax.shard_map(
        lambda s, st: parse_kernel.parse_rows(s, st, M._ROW), mesh=mesh,
        in_specs=PartitionSpec("rows"), out_specs=PartitionSpec("rows"),
        check_vma=False,
    ))
    mlen, _, starts, _ = _batch(2 * len(gpus), 16384, 5, 0.3)
    step = np.asarray(jnp.where(mlen >= 3, mlen, 1).astype(jnp.int32))
    want = np.asarray(jax.jit(M._parse_rows_xla)(step, starts))
    got = np.asarray(per_card(jax.device_put(step, rows),
                              jax.device_put(np.asarray(starts), rows)))
    assert np.array_equal(got, want)
    assert want.sum() > 0
