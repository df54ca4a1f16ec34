"""The chip smoke (chip_smoke.py): its helpers and gates on the CPU, and
the same checks at full size on an NVIDIA GPU.

Tests marked `chip` need a GPU and skip elsewhere; on the card run them
with `JAX_PLATFORMS=cuda,cpu python -m pytest -m chip tests/test_chip.py`.
Whether a GPU is there is decided in a fixture, never at import.
"""
import os
import sys

import jax
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import __graft_entry__ as graft  # noqa: E402
import chip_smoke  # noqa: E402
from gridpp_tpu import device  # noqa: E402
from tools.roofline import chip_peaks  # noqa: E402


def _all_ok(rows):
    bad = [(name, row) for name, row in rows if not row.get("ok", True)]
    assert not bad, bad


# --- CPU: gates, cache, peaks ---------------------------------------------
def test_device_gate_refuses_cpu():
    with pytest.raises(device.NoGPUError):
        device.require_gpu()


def test_smoke_refuses_cpu_without_result(capsys):
    assert chip_smoke.main([]) == 2
    out = capsys.readouterr()
    assert "no GPU found" in out.err
    assert '"ok"' not in out.out


def test_compile_cache_default_dir(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    old = jax.config.jax_compilation_cache_dir
    try:
        path = device.enable_compile_cache()
        assert path == os.path.join(ROOT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_off_for_installed_package(monkeypatch, tmp_path):
    """An installed package (no chip_smoke.py or .git beside it) keeps no
    cache and writes nothing into its install tree."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    pkg = tmp_path / "site-packages" / "gridpp_tpu"
    pkg.mkdir(parents=True)
    monkeypatch.setattr(device, "PACKAGE_DIR", str(pkg))
    old = jax.config.jax_compilation_cache_dir
    assert device.checkout() is None
    assert device.enable_compile_cache() is None
    assert jax.config.jax_compilation_cache_dir == old
    assert os.listdir(tmp_path / "site-packages") == ["gridpp_tpu"]


def test_compile_cache_env_dir_wins(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    old = jax.config.jax_compilation_cache_dir
    assert device.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; no other directory is set
    assert jax.config.jax_compilation_cache_dir == old


def test_dryrun_multichip_needs_its_devices():
    with pytest.raises(RuntimeError, match="needs 64 devices"):
        graft.dryrun_multichip(64)


def test_chip_peaks_h100_row():
    peaks = chip_peaks("NVIDIA H100 80GB HBM3")
    assert peaks["gbytes_s"] == 3_350.0
    assert peaks["gflops"] == 67_000.0
    assert peaks["tf32_gflops"] == 495_000.0


def test_chip_peaks_unknown_kind_raises():
    with pytest.raises(ValueError, match="no published peaks"):
        chip_peaks("NVIDIA A100-SXM4-40GB")
    with pytest.raises(ValueError):
        chip_peaks()  # this CPU device has no row


# --- CPU: the smoke's checks at small sizes -------------------------------
def test_smoke_compare():
    ok = chip_smoke.compare(np.array([1.0, np.nan]), np.array([1.005, np.nan]))
    assert ok["ok"] and ok["n_over_1e-3"] == 1
    assert not chip_smoke.compare(np.array([1.0, 2.0]),
                                  np.array([1.0, 2.02]))["ok"]
    assert not chip_smoke.compare(np.array([np.nan]), np.array([1.0]))["ok"]
    assert not chip_smoke.compare(np.zeros(2), np.zeros(3))["ok"]


def test_smoke_pipeline_48():
    """Phase 2 on a 48^2 problem: every path, serve_stream and the
    one-hot paging against the host API."""
    rows, resolve_s = chip_smoke.check_pipeline(n=48, n_obs=60)
    _all_ok(rows)
    assert resolve_s > 0
    names = [name for name, _ in rows]
    for path in ("fast", "general", "resolve"):
        assert f"run_device path={path}" in names


def test_smoke_ensembles_48():
    _all_ok(chip_smoke.check_ensemble(n=48, n_obs=60, e=4))
    _all_ok(chip_smoke.check_ensemble(n=48, n_obs=80, e=10, max_points=8))
    _all_ok(chip_smoke.check_ensemble_full(n=48, n_obs=60, e=4))


def test_smoke_device_ops_64():
    _all_ok(chip_smoke.check_device_ops(n=64))


def test_smoke_stencil_times_refuse_unknown_device():
    """No roofline without a row in the peak table: the phase raises
    rather than printing times alone."""
    with pytest.raises(ValueError, match="no published peaks"):
        chip_smoke.check_stencil_times(n=64)


def test_smoke_four_on_virtual_devices():
    """The --four comparison on four of the suite's virtual CPU devices."""
    _all_ok(chip_smoke.check_four(n=64, n_obs=50, e=4))


def test_smoke_public_api_sweep():
    rows = chip_smoke.check_public_api()
    _all_ok(rows)
    assert rows[0][1]["uncovered"] == []


# --- on the card ----------------------------------------------------------
@pytest.fixture
def gpu():
    try:
        return device.require_gpu()
    except device.NoGPUError as e:
        pytest.skip(f"needs an NVIDIA GPU ({e})")


@pytest.mark.chip
def test_chip_pipeline(gpu):
    rows, _ = chip_smoke.check_pipeline()
    _all_ok(rows)


@pytest.mark.chip
def test_chip_ensembles(gpu):
    _all_ok(chip_smoke.check_ensemble())
    _all_ok(chip_smoke.check_ensemble(n=128, n_obs=400, max_points=8))
    _all_ok(chip_smoke.check_ensemble_full())


@pytest.mark.chip
def test_chip_device_ops(gpu):
    _all_ok(chip_smoke.check_device_ops())
    _all_ok(chip_smoke.check_stencil_times())


@pytest.mark.chip
def test_chip_public_api(gpu):
    _all_ok(chip_smoke.check_public_api())


@pytest.mark.chip
def test_chip_four_cards(gpu):
    if len(gpu) < 4:
        pytest.skip(f"needs four GPUs, found {len(gpu)}")
    _all_ok(chip_smoke.check_four())
