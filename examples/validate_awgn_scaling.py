"""AWGN finite-length scaling: measure the (3,6) sum-product waterfall
at several block lengths and fit the scaling law in sigma.

The reference has no AWGN channel at all; this framework's AWGN stack
(ops/soft_bp + the population-DE threshold sigma* = 0.879) gets the
same finite-length treatment the BEC family has: FER at three block
lengths near threshold, probit-fit to
P_block = Phi(-sqrt(n)(sigma* - sigma - beta n^(-2/3)) / alpha_sigma),
including the 3-parameter variant (utils.theory.fit_waterfall_full)
whose fitted threshold is an INDEPENDENT finite-length measurement of
sigma* to compare with density evolution.

No expurgation needed: the regular (3,6) ensemble has lambda2 = 0 (no
cycle floor); sub-threshold failures are waterfall mass.

Run on the GPU.  Writes docs/data/awgn_scaling.json and
docs/figures/awgn_waterfall_scaling.png.
"""

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: decoder variants: sum-product f32 vs the production int8 min-sum,
#: each against its OWN population-DE threshold (docs/VALIDATION.md)
VARIANTS = {
    "sumproduct": dict(
        decoder="sumproduct", msg_dtype="float32", sigma_star=0.879,
        grid={1024: [0.790, 0.805, 0.820, 0.835, 0.850],
              4096: [0.820, 0.832, 0.844, 0.856, 0.866],
              16384: [0.844, 0.852, 0.858, 0.864, 0.870]},
        tag=""),
    "minsum-int8": dict(
        decoder="minsum", msg_dtype="int8", sigma_star=0.8220,
        grid={1024: [0.733, 0.748, 0.763, 0.778, 0.793],
              4096: [0.763, 0.775, 0.787, 0.799, 0.809],
              16384: [0.787, 0.795, 0.801, 0.807, 0.813]},
        tag="_int8"),
    # the irregular rate-1/2 pair: its only AWGN threshold anchor is the
    # GAUSSIAN-APPROXIMATION value 0.9043 (~0.5% pessimistic by
    # construction); the fitted threshold here is an exact-DE-equivalent
    # measurement, so fit-minus-GA quantifies the GA error.  The pair's
    # AWGN lambda2 cycle floor is LARGE (measured FER ~0.08-0.15 deep
    # below threshold at n=1024-4096), so this variant uses soft
    # expurgation (s = n/100; the round-4 engine extension).
    "irregular": dict(
        decoder="sumproduct", msg_dtype="float32", sigma_star=0.9043,
        lam=[0.0, 1 / 3, 0.0, 2 / 3],
        rho=[0.0, 0.0, 0.0, 0.0, 0.0, 1.0], expurgate=True,
        grid={1024: [0.815, 0.830, 0.845, 0.860, 0.875],
              4096: [0.845, 0.857, 0.869, 0.879, 0.888],
              16384: [0.869, 0.877, 0.883, 0.889, 0.894]},
        tag="_irregular"),
}
VARIANT = VARIANTS[sys.argv[1] if len(sys.argv) > 1 else "sumproduct"]
SIGMA_STAR_DE = VARIANT["sigma_star"]
GRID = VARIANT["grid"]
TRIALS = {1024: 16384, 4096: 16384, 16384: 8192}
BATCH = {1024: 4096, 4096: 4096, 16384: 1024}


def run_point(n, sigma, trials, seed=29):
    from iib_project_ldpc_codes_tpu.parallel.montecarlo import run_simulation
    from iib_project_ldpc_codes_tpu.utils.config import SimulationConfig
    from iib_project_ldpc_codes_tpu.utils.stats import fer_ci

    cfg = SimulationConfig(
        channel="AWGN", channel_param=sigma, n=n, dv=3, dc=6,
        lam=VARIANT.get("lam"), rho=VARIANT.get("rho"),
        decoder=VARIANT["decoder"], soft_msg_dtype=VARIANT["msg_dtype"],
        expurgation=(max(32, n // 100) if VARIANT.get("expurgate")
                     else None),
        iterations=100, num_tests=trials,
        batch=BATCH[n], codes_per_chunk=BATCH[n] // 32,
        max_block_errors=10 ** 9, seed=seed, code_mode="ensemble")
    t0 = time.time()
    res = run_simulation(cfg)
    lo, hi = fer_ci(res)
    return dict(n=n, sigma=sigma, trials=res.num_trials,
                fer=res.block_error_rate, fer_lo=lo, fer_hi=hi,
                block_errors=res.block_errors,
                seconds=round(time.time() - t0, 1))


def main():
    import jax
    import jax.numpy as jnp

    print("devices:", jax.devices(), flush=True)
    from iib_project_ldpc_codes_tpu.utils import theory

    part_path = os.path.join(ROOT, "docs", "data",
                             f"awgn_scaling_points{VARIANT['tag']}.json")
    rows = []
    if os.path.exists(part_path):
        with open(part_path) as f:
            rows = json.load(f)
    done = {(r["n"], r["sigma"]) for r in rows}
    for n, grid in GRID.items():
        for sigma in grid:
            if (n, sigma) in done:
                continue
            r = run_point(n, sigma, TRIALS[n])
            rows.append(r)
            with open(part_path, "w") as f:
                json.dump(rows, f, indent=1)
            print(f"n={n} sigma={sigma}: FER={r['fer']:.4f} "
                  f"({r['block_errors']} events, {r['seconds']}s)",
                  flush=True)

    pts = [(r["n"], r["sigma"], r["fer"]) for r in rows]
    alpha, beta = theory.fit_waterfall_alpha(pts, SIGMA_STAR_DE)
    a3, b3, thr_hat = theory.fit_waterfall_full(pts)
    print(f"fit at DE threshold {SIGMA_STAR_DE}: alpha={alpha:.4f} "
          f"beta={beta:.4f}", flush=True)
    print(f"3-parameter fit: alpha={a3:.4f} beta={b3:.4f} "
          f"sigma*_hat={thr_hat:.4f} (DE: {SIGMA_STAR_DE})", flush=True)

    per_n = {}
    for n in GRID:
        sub = [(r["n"], r["sigma"], r["fer"]) for r in rows
               if r["n"] == n and 0 < r["fer"] < 1]
        z = [theory._norm_ppf_np(f) for _, _, f in sub]
        b = [-np.sqrt(n) * (thr_hat - s - b3 * n ** (-2 / 3))
             for _, s, _ in sub]
        per_n[n] = float(np.dot(b, z) / np.dot(z, z))
        print(f"alpha_hat(n={n}) = {per_n[n]:.4f}", flush=True)

    with open(os.path.join(ROOT, "docs", "data",
                           f"awgn_scaling{VARIANT['tag']}.json"), "w") as f:
        json.dump(dict(sigma_star_de=SIGMA_STAR_DE, alpha=alpha,
                       beta=beta, alpha3=a3, beta3=b3,
                       sigma_star_fit=thr_hat, alpha_per_n=per_n,
                       points=rows), f, indent=1)

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 5))
    for n in GRID:
        rs = sorted([r for r in rows if r["n"] == n],
                    key=lambda r: r["sigma"])
        sig = [r["sigma"] for r in rs]
        ax.errorbar(sig, [r["fer"] for r in rs],
                    yerr=[[r["fer"] - r["fer_lo"] for r in rs],
                          [r["fer_hi"] - r["fer"] for r in rs]],
                    fmt="o", capsize=3, label=f"n={n}")
        grid = np.linspace(min(sig), thr_hat, 200)
        ax.plot(grid, theory.waterfall_block_error_fitted(
            n, grid, thr_hat, a3, b3), "--", lw=1)
    ax.axvline(SIGMA_STAR_DE, color="k", ls=":",
               label=f"DE sigma*={SIGMA_STAR_DE}")
    ax.axvline(thr_hat, color="r", ls=":", alpha=0.7,
               label=f"fitted sigma*={thr_hat:.4f}")
    ax.set_yscale("log")
    ax.set_ylim(1e-3, 1.2)
    ax.set_xlabel("AWGN noise sigma")
    ax.set_ylabel("FER")
    ax.set_title(f"(3,6) {VARIANT['decoder']}"
                 f"{' int8' if VARIANT['msg_dtype'] == 'int8' else ''} "
                 "AWGN waterfalls vs fitted scaling law")
    ax.legend(fontsize=8)
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(os.path.join(ROOT, "docs", "figures",
                             f"awgn_waterfall_scaling{VARIANT['tag']}.png"), dpi=130)
    print(f"wrote docs/data/awgn_scaling{VARIANT['tag']}.json + figure")


if __name__ == "__main__":
    main()
