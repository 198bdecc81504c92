"""Round-3 validation runs: huge-n waterfall + irregular ensembles.

Produces the measured-vs-law tables recorded in docs/VALIDATION.md:

  1. Edge-sharded Monte Carlo FER at n = 10^5 and 10^6 near the (3,6)
     threshold, against the finite-length scaling law
     P_block = Phi(-sqrt(n)(eps* - beta n^(-2/3) - eps)/alpha)
     (utils.theory.waterfall_block_error) -- statistics at block lengths
     beyond the reference's largest plotted n = 10^5
     (/root/reference/tools/plotting.py:357).
  2. Irregular (lambda, rho) = ((1/3)x + (2/3)x^3, x^5) rate-1/2 BER
     sweep at n = 8192 bracketing utils.theory.irregular_threshold
     (0.4526) and beating (3,6)-regular at the same rate -- the Monte
     Carlo confirmation of the irregular theory.

Run on the GPU (give it a long timeout):
    python examples/validate_round3.py [huge|irregular]
"""

from __future__ import annotations

import sys
import time

sys.path.insert(0, ".")  # run from the repo root

import jax
import jax.numpy as jnp
import numpy as np

from iib_project_ldpc_codes_tpu.models.ensemble import sample_code
from iib_project_ldpc_codes_tpu.parallel.mesh import make_mesh
from iib_project_ldpc_codes_tpu.parallel.montecarlo import run_simulation
from iib_project_ldpc_codes_tpu.utils.config import SimulationConfig
from iib_project_ldpc_codes_tpu.utils import theory
from iib_project_ldpc_codes_tpu.utils.stats import clopper_pearson

LAM = [0, 1 / 3, 0, 2 / 3]
RHO = [0, 0, 0, 0, 0, 1.0]


def huge_n_waterfall():
    """FER at n=1e5 and 1e6 near eps*(3,6) vs the scaling law."""
    mesh = make_mesh(jax.devices()[:1])
    for n, epss, trials, iters in (
            (100_000, (0.4250, 0.4275, 0.4290, 0.4310), 4096, 400),
            (1_000_000, (0.4280, 0.4288, 0.4292, 0.4298), 1024, 800)):
        code = sample_code(jax.random.key(1000 + n), n, 3, 6)
        print(f"# n={n}")
        print("eps    FER(meas)  95% CI           FER(law)   trials  secs")
        for eps in epss:
            cfg = SimulationConfig(
                channel="BEC", channel_param=eps, n=n, dv=3, dc=6,
                decoder="bp", iterations=iters, num_tests=trials,
                batch=min(trials, 1024), max_block_errors=10**9,
                seed=int(eps * 1e6), code_mode="fixed", edge_sharded=True)
            t = time.time()
            res = run_simulation(cfg, code=code, mesh=mesh)
            lo, hi = clopper_pearson(res.block_errors, res.num_trials)
            law = float(theory.waterfall_block_error(
                n, [eps], finite_size_shift=True)[0])
            print(f"{eps:.4f} {res.block_error_rate:9.4f}  "
                  f"[{lo:.4f},{hi:.4f}]  {law:9.4f}  {res.num_trials:6d}"
                  f"  {time.time() - t:5.1f}", flush=True)


def irregular_waterfall():
    """Irregular vs regular BER at rate 1/2, n=8192."""
    thr_irr = theory.irregular_threshold(LAM, RHO, 1e-7)
    thr_reg = theory.calc_threshold(3, 6)
    print(f"# irregular threshold {thr_irr:.4f}, regular {thr_reg:.4f}")
    print("eps    BER(irr)    FER(irr)   BER(reg)    FER(reg)   secs")
    for eps in (0.40, 0.42, 0.43, 0.44, 0.45, 0.46, 0.47):
        t = time.time()
        row = [f"{eps:.3f}"]
        for kw in (dict(lam=LAM, rho=RHO), dict(dv=3, dc=6)):
            cfg = SimulationConfig(
                channel="BEC", channel_param=eps, n=8192, decoder="bp",
                iterations=150, num_tests=4096, batch=1024,
                max_block_errors=10**9, seed=int(eps * 1e4),
                code_mode="ensemble", **kw)
            res = run_simulation(cfg)
            row.append(f"{res.bit_error_rate:10.3e} "
                       f"{res.block_error_rate:9.4f}")
        print("  ".join(row) + f"  {time.time() - t:5.1f}", flush=True)


if __name__ == "__main__":
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    if which in ("huge", "all"):
        huge_n_waterfall()
    if which in ("irregular", "all"):
        irregular_waterfall()
