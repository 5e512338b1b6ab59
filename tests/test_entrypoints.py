"""The compile-cache helper and chip_smoke.py's refusal to run off-GPU."""
import os
import shutil
import subprocess
import sys

import jax

from zzflate_tpu.utils import compile_cache

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cache_dir_honours_env(monkeypatch, tmp_path):
    want = str(tmp_path / "cc")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
    assert compile_cache.cache_dir() == want
    prev = jax.config.jax_compilation_cache_dir
    try:
        assert compile_cache.enable() == want
        assert jax.config.jax_compilation_cache_dir == want
        assert os.path.isdir(want)
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)


def test_cache_dir_default_is_repo_root(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compile_cache.cache_dir() == os.path.join(_REPO, ".jax_cache")


def _run_smoke(cwd, script):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run(
        [sys.executable, script, "--mib", "1"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_chip_smoke_refuses_cpu():
    r = _run_smoke(_REPO, os.path.join(_REPO, "chip_smoke.py"))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "needs a GPU" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(_REPO, "chip_smoke.py"), tmp_path)
    r = _run_smoke(str(tmp_path), str(tmp_path / "chip_smoke.py"))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
