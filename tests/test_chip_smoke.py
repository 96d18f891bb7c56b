"""chip_smoke.py refuses to run without a GPU, and the compile cache
follows JAX_COMPILATION_CACHE_DIR or stays inside the checkout."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from distributed_raytracer.utils import jaxtools

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _has_result_line(stdout: str) -> bool:
    lines = stdout.strip().splitlines()
    if not lines:
        return False
    try:
        return "ok" in json.loads(lines[-1])
    except ValueError:
        return False


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_gpu(tmp_path, where):
    """On a CPU-only host, in the checkout or copied alone into an empty
    directory, the smoke test exits non-zero and prints no result."""
    if where == "checkout":
        res = _run_smoke(REPO, "chip_smoke.py")
    else:
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        res = _run_smoke(str(tmp_path), "chip_smoke.py")
    assert res.returncode != 0
    assert not _has_result_line(res.stdout)


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cc"))
    assert jaxtools.compilation_cache_dir() == str(tmp_path / "cc")


def test_compile_cache_default_inside_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = jaxtools.compilation_cache_dir()
    assert got == os.path.join(REPO, ".jax_cache")
