"""Expurgated design ladder: the LP-designed ensembles' true waterfalls.

Round 3 measured the LP design ladder (docs/VALIDATION.md "design
ladder") with RAW BER; below threshold the lambda2 > 0 designs sit on
their small-stopping-set floor (~4e-4 at n=8192), which makes the
dv_max=6/8 designs look *worse* below threshold than the dv_max=4 pair
they dominate.  This rerun applies the reference's expurgation rule
(parallel_simulator_expurgated.py:238-243: trials whose final erasure
count is <= s are excluded from the statistics) with s = n/100 --
far above any O(1) stopping set, far below any Theta(n) waterfall
stall -- so the below-threshold columns show the expurgated-ensemble
waterfalls the designs actually have.

Run on the GPU.  Writes docs/data/design_ladder_expurgated.json and
docs/figures/design_ladder_expurgated_n8192.png.
"""

import json
import os
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RHO = [0.0, 0.0, 0.0, 0.0, 0.0, 1.0]
N = 8192
EPS = [0.42, 0.44, 0.46, 0.47]
TRIALS = {0.42: 65536, 0.44: 65536, 0.46: 65536, 0.47: 16384}


def run_point(lam, eps, trials, seed=23):
    from iib_project_ldpc_codes_tpu.parallel.montecarlo import run_simulation
    from iib_project_ldpc_codes_tpu.utils.config import SimulationConfig
    from iib_project_ldpc_codes_tpu.utils.stats import ber_ci

    # 4096 keeps each XLA execution well under the remote worker's
    # patience (8192-trial chunks at 150 iters ran ~60-80 s and
    # repeatedly crashed it near threshold)
    batch = 4096
    cfg = SimulationConfig(
        channel="BEC", channel_param=eps, n=N, lam=list(map(float, lam)),
        rho=RHO, decoder="bp", iterations=150, num_tests=trials,
        batch=batch, codes_per_chunk=batch // 32,
        expurgation=max(32, N // 100),
        max_block_errors=10 ** 9, seed=seed, code_mode="ensemble")
    t0 = time.time()
    res = run_simulation(cfg)
    lo, hi = ber_ci(res)
    return dict(eps=eps, trials=res.num_trials, ber=res.bit_error_rate,
                ber_hi=hi, fer=res.block_error_rate,
                bit_errors=res.bit_errors, excluded=res.excluded_trials,
                seconds=round(time.time() - t0, 1))


def main():
    import jax
    import jax.numpy as jnp

    print("devices:", jax.devices(), flush=True)
    from iib_project_ldpc_codes_tpu.utils import theory

    ensembles = []
    for dv_max in (4, 6, 8):
        lam, _ = theory.optimize_lambda_for_rate(RHO, dv_max, 0.5)
        thr = theory.irregular_threshold(lam, RHO, 1e-6)
        ensembles.append((f"LP dv_max={dv_max}", lam, thr))
        print(f"dv_max={dv_max}: eps*={thr:.4f}", flush=True)

    # incremental resume (a long run may be cut): completed points
    # are persisted and skipped on restart (fixed per-point seeds)
    part_path = os.path.join(ROOT, "docs", "data",
                             "design_ladder_points.json")
    part = {}
    if os.path.exists(part_path):
        with open(part_path) as f:
            part = json.load(f)
    results = {}
    for name, lam, thr in ensembles:
        rows = []
        for eps in EPS:
            k = f"{name}|{eps}"
            if k in part:
                rows.append(part[k])
                continue
            r = run_point(lam, eps, TRIALS[eps])
            rows.append(r)
            part[k] = r
            with open(part_path, "w") as f:
                json.dump(part, f, indent=1)
            print(f"{name} eps={eps}: expurgated BER={r['ber']:.3g} "
                  f"(<= {r['ber_hi']:.3g}), {r['excluded']} trials "
                  f"expurgated, {r['seconds']}s", flush=True)
        results[name] = dict(threshold=thr,
                             lam=[float(v) for v in lam], rows=rows)

    os.makedirs(os.path.join(ROOT, "docs", "data"), exist_ok=True)
    with open(os.path.join(ROOT, "docs", "data",
                           "design_ladder_expurgated.json"), "w") as f:
        json.dump(results, f, indent=1)

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    # round-3 raw-BER rows for contrast (docs/VALIDATION.md table)
    raw = {"LP dv_max=4": [9.9e-5, 1.1e-2, 2.9e-1, 3.4e-1],
           "LP dv_max=6": [4.7e-4, 9.4e-4, 7.7e-3, 8.9e-2],
           "LP dv_max=8": [4.3e-4, 8.2e-4, 7.0e-3, 6.3e-2]}
    fig, ax = plt.subplots(figsize=(7.5, 5))
    floor = None
    for i, (name, data) in enumerate(results.items()):
        c = f"C{i + 1}"  # match round-3 ladder colors (C0 = regular)
        eps = [r["eps"] for r in data["rows"]]
        ber = [max(r["ber"], 1e-9) for r in data["rows"]]
        ub = [r["ber_hi"] for r in data["rows"]]
        shown = [b if b > 1e-9 else u for b, u in zip(ber, ub)]
        mark = ["o" if b > 1e-9 else "v" for b in ber]
        for j, (e, v, m) in enumerate(zip(eps, shown, mark)):
            ax.plot([e], [v], m, color=c)
        ax.plot(eps, shown, "-", color=c,
                label=f"{name} expurgated (eps*={data['threshold']:.4f})")
        ax.plot(eps, raw[name], ":", color=c, alpha=0.6,
                label=f"{name} raw (round 3)")
        ax.axvline(data["threshold"], ls="--", color=c, alpha=0.4)
    ax.set_yscale("log")
    ax.set_xlabel("erasure probability")
    ax.set_ylabel("bit error rate")
    ax.set_title("Design ladder, expurgated (s = n/100) vs raw\n"
                 f"n = {N}; triangles = zero-error upper bounds")
    ax.legend(fontsize=7)
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(os.path.join(ROOT, "docs", "figures",
                             "design_ladder_expurgated_n8192.png"), dpi=130)
    print("wrote docs/data/design_ladder_expurgated.json + figure")


if __name__ == "__main__":
    main()
