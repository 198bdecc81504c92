"""chip_smoke.py's wiring, the device guard and the compile-cache helper,
on the CPU; plus the smoke run itself on a card, where one is present."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from iib_project_ldpc_codes_tpu.utils import runtime

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402


@pytest.fixture
def no_cache_env(monkeypatch):
    """Keep the phases' CLI call from pointing this process's compile
    cache at the checkout: with the variable set, the helper sets
    nothing (JAX read the variable, if at all, when it was imported)."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "unused-by-this-process")


@pytest.mark.parametrize("name", [n for n, _ in chip_smoke.PHASES])
def test_smoke_phase_runs_at_toy_size(name, no_cache_env):
    """Every one-card phase at toy size, the CPU device against itself:
    catches drift between the phases and the APIs they drive."""
    phase = dict(chip_smoke.PHASES)[name]
    cpu = jax.devices("cpu")[0]
    record = phase([cpu], cpu, chip_smoke.TOY)
    assert record["compare"]
    assert record["trials_per_s"] > 0
    json.dumps(record)  # printable as the phase's line


@pytest.mark.parametrize("name", [n for n, _ in chip_smoke.FOUR_CARD_PHASES])
def test_four_card_phase_runs_on_virtual_devices(name):
    """The --four-cards phases on four virtual CPU devices, each against
    one device alone."""
    phase = dict(chip_smoke.FOUR_CARD_PHASES)[name]
    devices = jax.devices("cpu")
    assert len(devices) >= 4
    record = phase(devices, devices[0], chip_smoke.TOY)
    assert "4 distinct devices" in record["compare"]


def test_four_card_phase_refuses_one_device():
    cpu = jax.devices("cpu")[0]
    with pytest.raises(chip_smoke.SmokeFailure, match="need 4 devices"):
        chip_smoke.f1_batch_sharded([cpu], cpu, chip_smoke.TOY)


def test_device_guard_refuses_cpu():
    with pytest.raises(SystemExit, match="no GPU"):
        runtime.require_gpu(jax.devices("cpu"))


def test_smoke_refuses_to_run_without_gpu():
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       capture_output=True, text=True, timeout=300,
                       cwd=ROOT, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert runtime.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # nothing set


def test_compile_cache_defaults_to_fixed_checkout_dir(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = runtime.enable_compile_cache()
        assert path == str(ROOT / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        assert runtime.enable_compile_cache() == path  # same every call
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    ignored = (ROOT / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


@pytest.fixture
def gpu_present():
    """Decided here, not at import: skip unless nvidia-smi lists a card."""
    smi = shutil.which("nvidia-smi")
    listed = smi and subprocess.run([smi, "-L"], capture_output=True,
                                    text=True).stdout.strip()
    if not listed:
        pytest.skip("no NVIDIA GPU on this machine")


@pytest.mark.gpu
def test_chip_smoke_on_gpu(gpu_present):
    """The whole smoke run on the card.  This test process stays on the
    CPU (conftest.py), so the smoke process is the card's only user."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       capture_output=True, text=True, timeout=1200,
                       cwd=ROOT, env=env)
    assert r.returncode == 0, r.stderr[-4000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["device"]["platform"] == "gpu"
