"""CLI smoke tests + BSC/AWGN Monte Carlo chunk-path tests."""

import json
import subprocess
import sys

import jax
import numpy as np
import pytest

from iib_project_ldpc_codes_tpu.models import sample_code
from iib_project_ldpc_codes_tpu.parallel.mesh import make_mesh
from iib_project_ldpc_codes_tpu.parallel.montecarlo import run_simulation
from iib_project_ldpc_codes_tpu.utils.config import SimulationConfig


def test_gallager_mc_fixed():
    # n must be a few hundred+ for Gallager-A to help (short cycles
    # dominate at n~100)
    cfg = SimulationConfig(channel="BSC", channel_param=0.02, n=504, dv=3,
                           dc=6, decoder="gallager", iterations=20,
                           num_tests=512, batch=256,
                           max_block_errors=10**9, code_mode="fixed")
    code = sample_code(jax.random.key(1), cfg.n, cfg.dv, cfg.dc)
    res = run_simulation(cfg, code=code)
    assert res.num_trials == 512
    assert abs(res.error_rate_per_iteration[0] - 0.02) < 0.01
    assert res.bit_error_rate < 0.004  # decoder helps at low crossover


def test_awgn_mc_ensemble():
    cfg = SimulationConfig(channel="AWGN", channel_param=0.7, n=96, dv=3,
                           dc=6, decoder="sumproduct", iterations=20,
                           num_tests=128, batch=128, codes_per_chunk=2,
                           max_block_errors=10**9, code_mode="ensemble")
    res = run_simulation(cfg)
    assert res.num_trials == 128
    assert 0 <= res.bit_error_rate < 0.5


def test_minsum_mc_sharded():
    cfg = SimulationConfig(channel="AWGN", channel_param=0.8, n=96, dv=3,
                           dc=6, decoder="minsum", iterations=15,
                           num_tests=256, batch=256,
                           max_block_errors=10**9, code_mode="fixed")
    code = sample_code(jax.random.key(2), cfg.n, cfg.dv, cfg.dc)
    mesh = make_mesh()
    r1 = run_simulation(cfg, code=code, mesh=mesh)
    r2 = run_simulation(cfg, code=code, mesh=mesh)
    assert r1.bit_errors == r2.bit_errors  # deterministic under sharding


def test_config_rejects_bad_combo():
    with pytest.raises(ValueError):
        SimulationConfig(channel="AWGN", decoder="bp")
    with pytest.raises(ValueError):
        SimulationConfig(channel="BEC", decoder="gallager")


def _run_cli(args):
    return subprocess.run(
        [sys.executable, "-m", "iib_project_ldpc_codes_tpu.cli"] + args,
        capture_output=True, text=True, timeout=600)


def test_cli_reference_argv(tmp_path):
    r = _run_cli(["0.42", "256", "20", "96", "3", "6", "0", "5",
                  "--platform=cpu", f"--output-dir={tmp_path}"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "block_error_rate=" in r.stdout
    files = list(tmp_path.iterdir())
    assert len(files) == 1
    data = json.loads(files[0].read_text())
    assert data["config"]["n"] == 96
    assert data["num_trials"] >= 256


def test_cli_json_config(tmp_path):
    cfg = SimulationConfig(channel="BSC", channel_param=0.02, n=96, dv=3,
                           dc=6, decoder="gallager", iterations=10,
                           num_tests=128, batch=128,
                           max_block_errors=10**9,
                           code_mode="fixed", output_dir=str(tmp_path))
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(cfg.to_json())
    r = _run_cli([f"--config={cfg_path}", "--platform=cpu", "--legacy-csv"])
    assert r.returncode == 0, r.stderr[-2000:]
    exts = {p.suffix for p in tmp_path.iterdir()}
    assert ".csv" in exts and ".json" in exts


def test_cli_platform_gpu_pins_cuda_or_fails_loudly(tmp_path):
    """--platform=gpu pins jax_platforms to "cuda": on a machine with no
    CUDA card the run fails, and never carries on on the CPU."""
    prog = (
        "import jax\n"
        "from iib_project_ldpc_codes_tpu.cli import _apply_platform\n"
        "_apply_platform('gpu', None)\n"
        "print('PINNED', jax.config.jax_platforms)\n"
    )
    r = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split() == ["PINNED", "cuda"]

    r = _run_cli(["0.42", "64", "10", "96", "3", "6", "3", "1",
                  "--platform=gpu", f"--output-dir={tmp_path}"])
    if r.returncode == 0:  # a card is present: it must have been used
        assert "platform=gpu" in r.stdout
    else:
        assert "block_error_rate=" not in r.stdout
        assert "GPU" in r.stderr or "cuda" in r.stderr
        assert not list(tmp_path.iterdir())


def test_cli_reports_the_devices_it_runs_on(tmp_path):
    r = _run_cli(["0.42", "64", "10", "96", "3", "6", "3", "1",
                  "--platform=cpu", f"--output-dir={tmp_path}"])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "platform=cpu device_kind=cpu device_count=" in r.stdout


def test_cli_usage_error():
    r = _run_cli(["0.4", "10"])
    assert r.returncode == 2
    assert "Reference-compatible" in r.stdout


def test_gallager_b_threshold_option():
    """Gallager-B (t=1) differs from A (t=dv-1=2) and is wired through."""
    cfg_a = SimulationConfig(channel="BSC", channel_param=0.03, n=504,
                             dv=3, dc=6, decoder="gallager", iterations=20,
                             num_tests=256, batch=256,
                             max_block_errors=10**9, code_mode="fixed")
    cfg_b = SimulationConfig(channel="BSC", channel_param=0.03, n=504,
                             dv=3, dc=6, decoder="gallager", iterations=20,
                             gallager_threshold=1, num_tests=256, batch=256,
                             max_block_errors=10**9, code_mode="fixed")
    code = sample_code(jax.random.key(4), 504, 3, 6)
    ra = run_simulation(cfg_a, code=code)
    rb = run_simulation(cfg_b, code=code)
    assert ra.bit_errors != rb.bit_errors  # different update rules


def test_minsum_alpha_option():
    cfg = SimulationConfig(channel="AWGN", channel_param=0.85, n=96, dv=3,
                           dc=6, decoder="minsum", minsum_alpha=0.75,
                           iterations=15, num_tests=128, batch=128,
                           max_block_errors=10**9, code_mode="fixed")
    code = sample_code(jax.random.key(5), 96, 3, 6)
    r = run_simulation(cfg, code=code)
    assert r.num_trials == 128


def test_cli_expurgated_argv(tmp_path):
    """Reference 9-arg expurgated invocation
    (parallel_simulator_expurgated.py:425)."""
    r = _run_cli(["0.45", "256", "20", "96", "3", "6", "0", "5", "1",
                  "--platform=cpu", f"--output-dir={tmp_path}"])
    assert r.returncode == 0, r.stderr[-2000:]
    files = list(tmp_path.iterdir())
    assert len(files) == 1
    assert "expurgated=1" in files[0].name
    data = json.loads(files[0].read_text())
    assert data["config"]["expurgation"] == 1
    assert data["excluded_trials"] > 0
