"""Exact expurgated per-iteration series, demonstrated at scale (r5).

Round 5 made `expurgation` exact for the non-monotone decoder families:
the chunk decodes with ``record="per_trial"`` and drops excluded
trials' WHOLE per-iteration trajectories (parallel_simulator_expurgated
.py:238-243 semantics) -- previously the per-iteration series stayed
raw for Gallager/soft.  This driver measures the difference where it
matters, on the GPU:

  * panel A -- BSC Gallager-A (3,6), n=4096, p=0.03 (below p*=0.0394):
    the error floor is small absorbing sets; the raw per-iteration BER
    flattens at their level while the expurgated series (s = n/100)
    keeps decaying -- the curve the reference's expurgated simulator
    would produce.
  * panel B -- AWGN sum-product on the irregular rate-1/2 pair,
    n=4096 ensemble, sigma=0.84 (below the pair's threshold): the
    lambda2 > 0 cycle floor (O(1)-bit stopping-set analogues) dominates
    the raw tail; expurgation at s=10 removes it from the whole series.

Persists per-point results to docs/data/exact_expurgation.json and
skips completed points on restart (long runs must be resumable).  Renders docs/figures/exact_expurgation_curves.png.

Run (GPU, background): python examples/validate_exact_expurgation.py
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "docs", "data", "exact_expurgation.json")
FIG = os.path.join(ROOT, "docs", "figures", "exact_expurgation_curves.png")


def load():
    if os.path.exists(DATA):
        with open(DATA) as f:
            return json.load(f)
    return {}


def save(doc):
    os.makedirs(os.path.dirname(DATA), exist_ok=True)
    tmp = DATA + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1)
    os.replace(tmp, DATA)


def run_points():
    import jax.numpy as jnp
    import numpy as np


    from iib_project_ldpc_codes_tpu.parallel.montecarlo import run_simulation
    from iib_project_ldpc_codes_tpu.utils.config import SimulationConfig

    doc = load()
    LAM = [0, 1 / 3, 0, 2 / 3]
    RHO = [0, 0, 0, 0, 0, 1.0]
    cases = {
        "gallager_raw": dict(channel="BSC", channel_param=0.03, n=4096,
                             dv=3, dc=6, decoder="gallager",
                             iterations=50, num_tests=16384, batch=2048,
                             max_block_errors=10 ** 9, seed=5,
                             code_mode="ensemble"),
        "gallager_exp": dict(channel="BSC", channel_param=0.03, n=4096,
                             dv=3, dc=6, decoder="gallager",
                             iterations=50, num_tests=16384, batch=2048,
                             max_block_errors=10 ** 9, seed=5,
                             code_mode="ensemble", expurgation=40),
        "soft_raw": dict(channel="AWGN", channel_param=0.84, n=4096,
                         lam=LAM, rho=RHO, decoder="sumproduct",
                         iterations=60, num_tests=8192, batch=2048,
                         codes_per_chunk=64, max_block_errors=10 ** 9,
                         seed=7, code_mode="ensemble"),
        "soft_exp": dict(channel="AWGN", channel_param=0.84, n=4096,
                         lam=LAM, rho=RHO, decoder="sumproduct",
                         iterations=60, num_tests=8192, batch=2048,
                         codes_per_chunk=64, max_block_errors=10 ** 9,
                         seed=7, code_mode="ensemble", expurgation=10),
    }
    for name, kw in cases.items():
        if name in doc:
            print(f"{name}: cached", flush=True)
            continue
        t = time.time()
        r = run_simulation(SimulationConfig(**kw))
        doc[name] = dict(
            n=kw["n"], channel=kw["channel"], param=kw["channel_param"],
            expurgation=kw.get("expurgation"),
            num_trials=r.num_trials, excluded=r.excluded_trials,
            ber=r.bit_error_rate, fer=r.block_error_rate,
            series=r.error_rate_per_iteration)
        save(doc)
        print(f"{name}: BER={r.bit_error_rate:.3e} FER="
              f"{r.block_error_rate:.4f} excluded={r.excluded_trials} "
              f"({time.time() - t:.0f}s)", flush=True)
    return doc


def render(doc):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2, figsize=(10, 4.2), sharey=False)
    panels = [("gallager", "BSC Gallager-A (3,6), n=4096, p=0.03",
               "s = 40 (n/100)"),
              ("soft", "AWGN sum-product, irregular pair, n=4096, "
               "$\\sigma$=0.84", "s = 10")]
    for ax, (k, title, slabel) in zip(axes, panels):
        raw, exp = doc[f"{k}_raw"], doc[f"{k}_exp"]
        ax.semilogy(raw["series"], label="raw ensemble", color="#1f77b4")
        ax.semilogy(exp["series"],
                    label=f"expurgated ({slabel}), exact series",
                    color="#d62728")
        ax.set_title(title, fontsize=10)
        ax.set_xlabel("iteration")
        ax.grid(True, which="both", alpha=0.25)
        ax.legend(fontsize=8)
        frac = exp["excluded"] / exp["num_trials"]
        ax.annotate(f"excluded {exp['excluded']}/{exp['num_trials']} "
                    f"trials ({100 * frac:.1f}%)",
                    xy=(0.97, 0.96), xycoords="axes fraction",
                    ha="right", va="top", fontsize=8)
    axes[0].set_ylabel("bit error rate after iteration")
    fig.suptitle("Exact expurgated per-iteration series "
                 "(round 5: excluded trials' whole trajectories dropped)",
                 fontsize=11)
    fig.tight_layout(rect=[0, 0, 1, 0.94])
    os.makedirs(os.path.dirname(FIG), exist_ok=True)
    fig.savefig(FIG, dpi=150)
    print("wrote", FIG, flush=True)


if __name__ == "__main__":
    doc = run_points()
    render(doc)
    print("DONE", flush=True)
