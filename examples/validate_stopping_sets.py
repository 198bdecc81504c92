"""Close SURVEY section 4 method 4 at reference scale: exact stopping-set
ensemble averages vs fresh-code Monte Carlo BER.

The reference computes exact finite-length ensemble-average bit error by
stopping-set enumeration (test_finite_length_analysis.py:92-109) and
hardcodes the values next to its simulated curves
(tools/plotting.py:50-71).  Here the loop is closed end-to-end with
measured agreement:

  * exact values from utils.stopping_sets.StoppingSetAnalysis
    .bit_error_bulk (certified truncation bound), cached in
    docs/data/exact_stopping_set_ber.json by a prior CPU run;
  * Monte Carlo with sampler="raw" -- the UNCONDITIONED configuration
    model, which is the ensemble the analysis averages over (its T(v)
    counts all socket matchings, multi-edges included);
  * the simplicity-conditioning bias of the production samplers is
    *measured* alongside (repair/reject exclude multi-edge obstructions,
    biasing small-n BER low).

Run on the GPU (default platform).  Writes docs/data/
stopping_set_closure.json and docs/figures/stopping_set_closure.png.
"""

import json
import os
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (n, eps) -> Monte Carlo trial budget; sized for >= ~1k block-error
# events at the exact BER scale (3e-5 .. 5e-2)
POINTS = {
    (512, 0.3): 1_048_576,
    (512, 0.35): 262_144,
    (512, 0.4): 65_536,
    (1024, 0.35): 524_288,
    (1024, 0.3): 4_194_304,
}


def exact_values():
    path = os.path.join(ROOT, "docs", "data", "exact_stopping_set_ber.json")
    raw = {}
    if os.path.exists(path):
        with open(path) as f:
            raw = json.load(f)
    out = {}
    for k, v in raw.items():
        n_s, eps_s = k.split("_")
        out[(int(n_s[2:]), float(eps_s[4:]))] = v["exact"]
    if (100, 0.3) not in out:   # cheap (~2 s); the reference's own anchor
        from iib_project_ldpc_codes_tpu.utils.stopping_sets import \
            StoppingSetAnalysis

        out[(100, 0.3)] = StoppingSetAnalysis(100, 3, 6, X=1) \
            .bit_error_bulk(0.3)[0]
    return out


def run_mc(n, eps, num_tests, sampler="raw", seed=101, batch=8192):
    from iib_project_ldpc_codes_tpu.parallel.montecarlo import run_simulation
    from iib_project_ldpc_codes_tpu.utils.config import SimulationConfig
    from iib_project_ldpc_codes_tpu.utils.stats import ber_ci

    cfg = SimulationConfig(
        channel="BEC", channel_param=eps, n=n, dv=3, dc=6, decoder="bp",
        iterations=100, num_tests=num_tests, batch=batch,
        codes_per_chunk=batch // 32, sampler=sampler,
        max_block_errors=10 ** 9, seed=seed, code_mode="ensemble")
    t0 = time.time()
    res = run_simulation(cfg)
    lo, hi = ber_ci(res)
    return dict(n=n, eps=eps, sampler=sampler, trials=res.num_trials,
                ber=res.bit_error_rate, ci_lo=lo, ci_hi=hi,
                bit_errors=res.bit_errors, block_errors=res.block_errors,
                seconds=round(time.time() - t0, 1))


def main():
    import jax
    import jax.numpy as jnp

    print("devices:", jax.devices(), flush=True)
    exact = exact_values()

    rows = []
    for (n, eps), trials in POINTS.items():
        if (n, eps) not in exact:
            print(f"skip (n={n}, eps={eps}): no exact value yet", flush=True)
            continue
        r = run_mc(n, eps, trials)
        r["exact"] = exact[(n, eps)]
        r["inside_ci"] = bool(r["ci_lo"] <= r["exact"] <= r["ci_hi"])
        r["rel_dev"] = r["ber"] / r["exact"] - 1.0
        rows.append(r)
        print(f"n={n} eps={eps}: exact={r['exact']:.4g} "
              f"MC={r['ber']:.4g} CI=({r['ci_lo']:.4g},{r['ci_hi']:.4g}) "
              f"inside={r['inside_ci']} rel={r['rel_dev']:+.1%} "
              f"[{r['seconds']}s]", flush=True)

    # simplicity-conditioning bias of the production sampler, measured
    bias = []
    for n, eps, trials in [(100, 0.3, 262_144), (512, 0.35, 262_144)]:
        if (n, eps) not in exact:
            continue
        r = run_mc(n, eps, trials, sampler="repair")
        r["exact"] = exact[(n, eps)]
        r["rel_dev"] = r["ber"] / r["exact"] - 1.0
        bias.append(r)
        print(f"[simple-conditioned] n={n} eps={eps}: MC={r['ber']:.4g} "
              f"vs exact={r['exact']:.4g} rel={r['rel_dev']:+.1%}", flush=True)

    os.makedirs(os.path.join(ROOT, "docs", "data"), exist_ok=True)
    out_path = os.path.join(ROOT, "docs", "data",
                            "stopping_set_closure.json")
    # merge with any previous pass (the exact n=1024 values land later
    # than the n=512 ones; each pass only reruns what it computed)
    doc = dict(raw_ensemble=[], simple_conditioned=[])
    if os.path.exists(out_path):
        with open(out_path) as f:
            doc = json.load(f)

    def merge(old, new):
        keyed = {(r["n"], r["eps"], r["sampler"]): r for r in old}
        keyed.update({(r["n"], r["eps"], r["sampler"]): r for r in new})
        return sorted(keyed.values(), key=lambda r: (r["n"], r["eps"]))

    doc["raw_ensemble"] = rows = merge(doc["raw_ensemble"], rows)
    doc["simple_conditioned"] = merge(doc["simple_conditioned"], bias)
    with open(out_path, "w") as f:
        json.dump(doc, f, indent=1)

    # overlay figure: exact stars on the measured BER-vs-eps curves
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(7, 5))
    for n in sorted({r["n"] for r in rows}):
        rs = sorted([r for r in rows if r["n"] == n], key=lambda r: r["eps"])
        eps = [r["eps"] for r in rs]
        ax.errorbar(eps, [r["ber"] for r in rs],
                    yerr=[[r["ber"] - r["ci_lo"] for r in rs],
                          [r["ci_hi"] - r["ber"] for r in rs]],
                    fmt="o-", capsize=4, label=f"MC raw ensemble n={n}")
        ax.plot(eps, [r["exact"] for r in rs], "k*", ms=12,
                label=f"exact analysis n={n}")
    ax.set_yscale("log")
    ax.set_xlabel("erasure probability")
    ax.set_ylabel("ensemble-average BER")
    ax.set_title("Exact stopping-set analysis vs Monte Carlo, (3,6) BEC")
    ax.legend(fontsize=8)
    ax.grid(alpha=0.3)
    fig.savefig(os.path.join(ROOT, "docs", "figures",
                             "stopping_set_closure.png"),
                dpi=120, bbox_inches="tight")
    print("wrote docs/data/stopping_set_closure.json and "
          "docs/figures/stopping_set_closure.png")


if __name__ == "__main__":
    main()
