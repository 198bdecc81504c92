"""Render the round-3 validation figures from the measured data.

Reproduces docs/figures/{irregular_vs_regular_n8192.png,
waterfall_scaling_n1e5_1e6.png} from the tables recorded in
docs/VALIDATION.md (measured on one device by
examples/validate_round3.py).  Matplotlib-only, repo figure style:
one axis, fixed series colors, dashed theory overlays, log-scale BER.
"""

import sys

sys.path.insert(0, ".")

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np

from iib_project_ldpc_codes_tpu.utils import theory

LAM = [0, 1 / 3, 0, 2 / 3]
RHO = [0, 0, 0, 0, 0, 1.0]


def irregular_vs_regular():
    eps = [0.40, 0.42, 0.43, 0.44, 0.45, 0.46, 0.47]
    ber_irr = [7.9e-05, 9.6e-05, 2.3e-04, 1.2e-02, 1.3e-01, 2.9e-01,
               3.4e-01]
    ber_reg = [1e-07, 2.3e-02, 1.6e-01, 2.7e-01, 3.1e-01, 3.4e-01,
               3.7e-01]  # 0.40 point measured 0 / 4096 trials: floor marker
    fig, ax = plt.subplots(figsize=(7, 5))
    ax.plot(eps, ber_irr, "o-", color="C0",
            label="irregular λ=(1/3)x+(2/3)x³, ρ=x⁵")
    ax.plot(eps[1:], ber_reg[1:], "s-", color="C1", label="(3,6) regular")
    thr_i = theory.irregular_threshold(LAM, RHO, 1e-6)
    thr_r = theory.calc_threshold(3, 6)
    ax.axvline(thr_i, ls="--", color="C0", alpha=0.6,
               label=f"irregular ε* = {thr_i:.4f}")
    ax.axvline(thr_r, ls="--", color="C1", alpha=0.6,
               label=f"regular ε* = {thr_r:.4f}")
    ax.set_yscale("log")
    ax.set_xlabel("erasure probability ε")
    ax.set_ylabel("bit error rate")
    ax.set_title("Irregular vs regular at rate 1/2, n = 8192\n"
                 "(4096 trials/point, one device)")
    ax.legend(fontsize=8)
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig("docs/figures/irregular_vs_regular_n8192.png", dpi=130)


def waterfall_scaling():
    data = {
        100_000: ([0.4250, 0.4275, 0.4290, 0.4310],
                  [0.0093, 0.1655, 0.4685, 0.8364]),
        1_000_000: ([0.4280, 0.4288, 0.4292, 0.4298],
                    [0.0068, 0.1299, 0.3818, 0.7852]),
    }
    fig, ax = plt.subplots(figsize=(7, 5))
    for color, (n, (eps, fer)) in zip(("C0", "C1"), data.items()):
        ax.plot(eps, fer, "o", color=color, label=f"measured n = {n:.0e}")
        grid = np.linspace(min(eps) - 5e-4, max(eps) + 5e-4, 300)
        ax.plot(grid, theory.waterfall_block_error(
            n, grid, 3, 6, finite_size_shift=True), "--", color=color,
            alpha=0.7, label=f"scaling law n = {n:.0e}")
    ax.set_xlabel("erasure probability ε")
    ax.set_ylabel("block (frame) error rate")
    ax.set_title("FER vs the finite-length scaling law "
                 "Φ(−√n(ε*−βn^(-2/3)−ε)/α)\n"
                 "edge-sharded Monte Carlo, one device")
    ax.legend(fontsize=8)
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig("docs/figures/waterfall_scaling_n1e5_1e6.png", dpi=130)


def design_ladder():
    eps = [0.42, 0.44, 0.46, 0.47, 0.48, 0.49]
    rows = [
        ("regular (3,6)", 0.4294,
         [2.4e-2, 2.7e-1, 3.4e-1, 3.7e-1, 3.9e-1, 4.1e-1]),
        ("LP dv_max=4", 0.4526,
         [9.9e-5, 1.1e-2, 2.9e-1, 3.4e-1, 3.7e-1, 4.0e-1]),
        ("LP dv_max=6", 0.4775,
         [4.7e-4, 9.4e-4, 7.7e-3, 8.9e-2, 2.7e-1, 3.6e-1]),
        ("LP dv_max=8", 0.4815,
         [4.3e-4, 8.2e-4, 7.0e-3, 6.3e-2, 2.2e-1, 3.4e-1]),
    ]
    fig, ax = plt.subplots(figsize=(7.5, 5))
    for i, (name, thr, ber) in enumerate(rows):
        c = f"C{i}"
        ax.plot(eps, ber, "o-", color=c, label=f"{name} (ε*={thr:.4f})")
        ax.axvline(thr, ls="--", color=c, alpha=0.5)
    ax.axvline(0.5, ls=":", color="k", alpha=0.6,
               label="Shannon limit (rate 1/2)")
    ax.set_yscale("log")
    ax.set_xlabel("erasure probability ε")
    ax.set_ylabel("bit error rate")
    ax.set_title("LP-designed ensemble ladder at rate 1/2, ρ=x⁵\n"
                 "n = 8192, 2048 trials/point, one device")
    ax.legend(fontsize=8)
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig("docs/figures/design_ladder_n8192.png", dpi=130)


if __name__ == "__main__":
    irregular_vs_regular()
    waterfall_scaling()
    design_ladder()
    print("wrote docs/figures/{irregular_vs_regular_n8192,"
          "waterfall_scaling_n1e5_1e6,design_ladder_n8192}.png")
