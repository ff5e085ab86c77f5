"""chip_smoke.py, bench.py's peak table, the compile-cache helper and the
profiler wrapper.

Tests marked ``gpu`` call chip_smoke.py's phase checks and skip without
a card; run them on a GPU host with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
"""

import contextlib
import importlib.util
import os
import shutil
import subprocess
import sys

import jax
import pytest

from stabilized_navier_stokes_flow_fenicsx.utils.compile_cache import (
    REPO_ROOT, compile_cache_dir, enable_compile_cache)
from stabilized_navier_stokes_flow_fenicsx.utils.profiling import (
    device_trace)


def _root_module(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO_ROOT, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(args, cwd, **env):
    return subprocess.run(
        [sys.executable] + args, cwd=cwd, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, **env))


def test_chip_smoke_refuses_the_cpu():
    out = _run(["chip_smoke.py"], REPO_ROOT, JAX_PLATFORMS="cpu")
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    assert '"ok": true' not in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """Without the package beside it the script fails and prints no
    result."""
    shutil.copy(os.path.join(REPO_ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_bench_peak_table_resolves_h100():
    peak = _root_module("bench").peak_rates("NVIDIA H100 80GB HBM3")
    assert peak == {"hbm_gbps": 3350.0, "fp32_gflops": 67000.0}


def test_bench_peak_table_rejects_unknown_device():
    with pytest.raises(KeyError, match="no published peaks"):
        _root_module("bench").peak_rates("cpu")


def test_compile_cache_dir_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compile_cache_dir() == os.path.join(REPO_ROOT, ".jax_cache")


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    old = jax.config.jax_compilation_cache_dir
    try:
        assert enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_lands_in_env_dir(tmp_path):
    """A compile in a fresh process writes its entry where the env var
    says."""
    code = ("from stabilized_navier_stokes_flow_fenicsx.utils.compile_cache "
            "import enable_compile_cache; enable_compile_cache(); "
            "import jax; jax.jit(lambda x: x * 2 + 1)(3.0)")
    out = _run(["-c", code], REPO_ROOT, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cache"),
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0")
    assert out.returncode == 0, out.stderr
    assert os.listdir(tmp_path / "cache")


def test_device_trace_lets_profiler_failure_raise(monkeypatch):
    @contextlib.contextmanager
    def broken(logdir):
        raise RuntimeError("profiler unavailable")
        yield

    monkeypatch.setattr(jax.profiler, "trace", broken)
    with pytest.raises(RuntimeError, match="profiler unavailable"):
        with device_trace("unused"):
            pass


def test_device_trace_passes_body_errors_through(tmp_path):
    with pytest.raises(ValueError, match="inside the trace"):
        with device_trace(str(tmp_path)):
            raise ValueError("inside the trace")


@pytest.fixture
def chip_smoke(gpu_device):
    return _root_module("chip_smoke")


@pytest.mark.gpu
def test_dfloat_exact_on_gpu(chip_smoke):
    chip_smoke.check_dfloat()


@pytest.mark.gpu
def test_df_residual_matches_f64_on_gpu(chip_smoke, tmp_path):
    from stabilized_navier_stokes_flow_fenicsx.utils.testimg import (
        make_annulus_image)

    chip_smoke.check_df_residual(
        make_annulus_image(str(tmp_path / "circle.png"), "circle"))


@pytest.mark.gpu
def test_production_parity_on_gpu(chip_smoke, tmp_path):
    from stabilized_navier_stokes_flow_fenicsx.utils.testimg import (
        make_annulus_image)

    chip_smoke.check_prod_parity(
        make_annulus_image(str(tmp_path / "circle.png"), "circle"))
