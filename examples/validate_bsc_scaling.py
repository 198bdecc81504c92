"""BSC Gallager-A finite-length scaling: the third channel family.

Same treatment as examples/validate_awgn_scaling.py for the
hard-decision family the reference also lacks: expurgated FER (the
Gallager-A floor is tiny 2-3-bit absorbing events — round-3 config-2
measured ~2 bits per sub-threshold failure — so s = n/100 removes it
cleanly now that round 4 wired expurgation into the Gallager chunk),
three block lengths, probit fits, and the 3-parameter fit's threshold
vs the DE value p*(3,6) = 0.0394.

Run on the GPU.  Writes docs/data/bsc_scaling.json and
docs/figures/bsc_waterfall_scaling.png.
"""

import json
import os
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P_STAR_DE = 0.039433      # theory.gallager_a_threshold(3, 6)

GRID = {
    1024: [0.026, 0.029, 0.032, 0.035, 0.038],
    4096: [0.031, 0.033, 0.035, 0.037, 0.0385],
    16384: [0.034, 0.0355, 0.0367, 0.0378, 0.0388],
}
TRIALS = {1024: 16384, 4096: 16384, 16384: 8192}
BATCH = {1024: 4096, 4096: 4096, 16384: 1024}


def run_point(n, p, trials, seed=31):
    from iib_project_ldpc_codes_tpu.parallel.montecarlo import run_simulation
    from iib_project_ldpc_codes_tpu.utils.config import SimulationConfig
    from iib_project_ldpc_codes_tpu.utils.stats import fer_ci

    cfg = SimulationConfig(
        channel="BSC", channel_param=p, n=n, dv=3, dc=6,
        decoder="gallager", iterations=60, num_tests=trials,
        batch=BATCH[n], codes_per_chunk=BATCH[n] // 32,
        expurgation=max(32, n // 100),
        max_block_errors=10 ** 9, seed=seed, code_mode="ensemble")
    t0 = time.time()
    res = run_simulation(cfg)
    lo, hi = fer_ci(res)
    return dict(n=n, p=p, trials=res.num_trials,
                fer=res.block_error_rate, fer_lo=lo, fer_hi=hi,
                block_errors=res.block_errors,
                excluded=res.excluded_trials,
                seconds=round(time.time() - t0, 1))


def main():
    import jax
    import jax.numpy as jnp

    print("devices:", jax.devices(), flush=True)
    from iib_project_ldpc_codes_tpu.utils import theory

    p_star = theory.gallager_a_threshold(3, 6)
    print(f"DE threshold p* = {p_star:.6f}", flush=True)

    part_path = os.path.join(ROOT, "docs", "data",
                             "bsc_scaling_points.json")
    rows = []
    if os.path.exists(part_path):
        with open(part_path) as f:
            rows = json.load(f)
    done = {(r["n"], r["p"]) for r in rows}
    for n, grid in GRID.items():
        for p in grid:
            if (n, p) in done:
                continue
            r = run_point(n, p, TRIALS[n])
            rows.append(r)
            with open(part_path, "w") as f:
                json.dump(rows, f, indent=1)
            print(f"n={n} p={p}: FER={r['fer']:.4f} "
                  f"({r['block_errors']} events, {r['excluded']} "
                  f"expurgated, {r['seconds']}s)", flush=True)

    pts = [(r["n"], r["p"], r["fer"]) for r in rows]
    alpha, beta = theory.fit_waterfall_alpha(pts, p_star)
    a3, b3, thr_hat = theory.fit_waterfall_full(pts)
    print(f"fit at DE threshold: alpha={alpha:.4f} beta={beta:.4f}",
          flush=True)
    print(f"3-parameter fit: alpha={a3:.4f} beta={b3:.4f} "
          f"p*_hat={thr_hat:.5f} (DE: {p_star:.5f})", flush=True)

    per_n = {}
    for n in GRID:
        sub = [(r["n"], r["p"], r["fer"]) for r in rows
               if r["n"] == n and 0 < r["fer"] < 1]
        z = [theory._norm_ppf_np(f) for _, _, f in sub]
        b = [-np.sqrt(n) * (thr_hat - p - b3 * n ** (-2 / 3))
             for _, p, _ in sub]
        per_n[n] = float(np.dot(b, z) / np.dot(z, z))
        print(f"alpha_hat(n={n}) = {per_n[n]:.4f}", flush=True)

    with open(os.path.join(ROOT, "docs", "data",
                           "bsc_scaling.json"), "w") as f:
        json.dump(dict(p_star_de=p_star, alpha=alpha, beta=beta,
                       alpha3=a3, beta3=b3, p_star_fit=thr_hat,
                       alpha_per_n=per_n, points=rows), f, indent=1)

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 5))
    for n in GRID:
        rs = sorted([r for r in rows if r["n"] == n],
                    key=lambda r: r["p"])
        ps = [r["p"] for r in rs]
        ax.errorbar(ps, [r["fer"] for r in rs],
                    yerr=[[r["fer"] - r["fer_lo"] for r in rs],
                          [r["fer_hi"] - r["fer"] for r in rs]],
                    fmt="o", capsize=3, label=f"n={n}")
        grid = np.linspace(min(ps), thr_hat, 200)
        ax.plot(grid, theory.waterfall_block_error_fitted(
            n, grid, thr_hat, a3, b3), "--", lw=1)
    ax.axvline(p_star, color="k", ls=":", label=f"DE p*={p_star:.4f}")
    ax.axvline(thr_hat, color="r", ls=":", alpha=0.7,
               label=f"fitted p*={thr_hat:.4f}")
    ax.set_yscale("log")
    ax.set_ylim(1e-3, 1.2)
    ax.set_xlabel("BSC crossover probability")
    ax.set_ylabel("expurgated FER")
    ax.set_title("(3,6) Gallager-A BSC waterfalls vs fitted scaling law")
    ax.legend(fontsize=8)
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(os.path.join(ROOT, "docs", "figures",
                             "bsc_waterfall_scaling.png"), dpi=130)
    print("wrote docs/data/bsc_scaling.json + figure")


if __name__ == "__main__":
    main()
