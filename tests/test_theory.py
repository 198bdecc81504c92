"""Theory-module regression anchors (BASELINE.md analytic constants)."""

import math

import numpy as np
import pytest

from iib_project_ldpc_codes_tpu.utils import theory


def test_threshold_3_6():
    # BASELINE.md: eps*(3,6) ~= 0.4294375 (bisection to 1e-9)
    thr = theory.calc_threshold(3, 6)
    assert abs(thr - 0.4294375) < 2e-5


def test_threshold_4_8():
    # BASELINE.md: eps*(4,8) ~= 0.3834453
    thr = theory.calc_threshold(4, 8)
    assert abs(thr - 0.3834453) < 2e-5


def test_below_threshold_boundaries():
    assert theory.below_threshold(0.42, 3, 6)
    assert not theory.below_threshold(0.43, 3, 6)
    assert theory.below_threshold(0.38, 4, 8)
    assert not theory.below_threshold(0.39, 4, 8)


def test_alpha_and_fixed_points_3_6():
    # BASELINE.md: alpha ~= 0.5595, y* ~= 0.7799, x* ~= 0.2612
    thr = theory.calc_threshold(3, 6)
    y = theory.threshold_y(thr, 3, 6)
    x = theory.threshold_x(thr, 3, 6)
    assert abs(y - 0.7799) < 1e-3
    assert abs(x - 0.2612) < 1e-3
    assert abs(theory.calculate_alpha(thr, 3, 6) - 0.5595) < 1e-3


def test_density_evolution_behaviour():
    # below threshold: decays to ~0; above: converges to positive fixpoint
    below = theory.density_evolution(0.40, 2000, 3, 6)
    above = theory.density_evolution(0.45, 2000, 3, 6)
    assert below[-1] < 1e-3 or len(below) < 2001
    assert above[-1] > 0.1
    # first element is the channel erasure probability
    assert below[0] == 0.40
    # monotone decreasing
    assert all(b1 >= b2 for b1, b2 in zip(below, below[1:]))


def test_modified_de_tracks_bit_erasure():
    curve = theory.modified_density_evolution(0.3, 11, 3, 6, 2e-50)
    # bit-erasure exponent dv vs edge exponent dv-1: bit curve sits below
    edge = theory.density_evolution(0.3, 11, 3, 6)
    assert curve[1] < edge[1]
    # reproduce the recursion by hand for the first step
    inner = 1 - (1 - 0.3) ** 5
    assert curve[1] == pytest.approx(0.3 * inner ** 3)


def test_finite_length_de_shift():
    shifted = theory.finite_length_density_evolution(0.4, 15, 100, 3, 6,
                                                     1e-10)
    assert shifted[0] == pytest.approx(0.4 + theory.BETA_3_6 * 100 ** (-2 / 3))


def test_waterfall_shape():
    eps = np.linspace(0.32, 0.5, 50)
    p1k = theory.waterfall_block_error(1000, eps)
    p5k = theory.waterfall_block_error(5000, eps)
    thr = theory.calc_threshold(3, 6)
    # P ~ 1/2 at threshold; steeper for larger n; monotone in eps
    i_thr = np.argmin(np.abs(eps - thr))
    assert abs(p1k[i_thr] - 0.5) < 0.05
    assert (np.diff(p1k) > 0).all()
    assert p5k[0] < p1k[0] and p5k[-1] > p1k[-1] - 1e-12


def test_critical_point():
    # Anchor: running the reference's test_critical_point_calculator.py
    # prints calculate_crit_epsilon(3,6) = 0.3747712850570679 (the eps where
    # the tangency fixed point first becomes positive).
    crit_eps = theory.calculate_crit_epsilon(3, 6)
    assert abs(crit_eps - 0.3747712850570679) < 1e-7
    # below crit_eps the fixed point collapses to 0, above it is positive
    assert theory.calculate_crit_point(0.37, 3, 6) < 1e-8
    assert theory.calculate_crit_point(0.40, 3, 6) > 0.5


def test_peeling_drift_properties():
    thr = theory.calc_threshold(3, 6)
    y = np.linspace(1e-3, 1.0, 200)
    # below threshold the normalized drift stays strictly positive
    r_below = theory.peeling_drift_normalized(0.40, 3, 6, y)
    assert (r_below > 0).all()
    # above threshold it dips negative somewhere
    r_above = theory.peeling_drift_normalized(0.44, 3, 6, y)
    assert r_above.min() < 0
    # absolute-units drift at step 0 equals dv*n*r(1)
    n = 500
    d0 = theory.peeling_drift(0.4, 3, 6, n, np.array([0.0]))
    assert d0[0] == pytest.approx(
        3 * n * theory.peeling_drift_normalized(0.4, 3, 6, 1.0))


def test_critical_point_variance_positive():
    v = theory.critical_point_variance(500, 0.34, 3, 6)
    assert v > 0


def test_degree_distribution_evolution():
    eps = 0.429
    init = theory.initial_degree_distribution(eps, 6)
    # distribution over degrees 1..6 sums to <= 1 (rest = removed checks)
    assert init.sum() <= 1.0 + 1e-9
    assert (init >= -1e-12).all()
    # at time just after start, mass shifts toward low degrees
    later = theory.degree_distribution_at_time(eps, 0.7, 3, 6)
    assert later.shape == (6,)
    assert np.isfinite(later).all()


def test_gallager_a_threshold_anchors():
    # Richardson/Urbanke values for Gallager algorithm A on the BSC
    assert abs(theory.gallager_a_threshold(3, 6) - 0.0394) < 5e-4
    assert abs(theory.gallager_a_threshold(4, 8) - 0.0476) < 5e-4


def test_gallager_a_de_behaviour():
    below = theory.gallager_a_density_evolution(0.03, 60, 3, 6)
    above = theory.gallager_a_density_evolution(0.05, 60, 3, 6)
    assert below[-1] < 1e-9
    assert above[-1] > 0.1
    assert below[0] == 0.03


def test_gallager_mc_consistent_with_de_threshold():
    """Monte Carlo Gallager-A behaviour flips across the analytic
    threshold (ops vs theory cross-validation)."""
    import jax

    from iib_project_ldpc_codes_tpu.models import sample_code
    from iib_project_ldpc_codes_tpu.ops.bitops import bernoulli_packed
    from iib_project_ldpc_codes_tpu.ops.gallager import gallager_decode_packed
    import numpy as np

    code = sample_code(jax.random.key(0), 2040, 3, 6)
    thr = theory.gallager_a_threshold(3, 6)
    lo = gallager_decode_packed(
        code, bernoulli_packed(jax.random.key(1), thr * 0.6, (2040, 4)), 40)
    hi = gallager_decode_packed(
        code, bernoulli_packed(jax.random.key(2), thr * 1.6, (2040, 4)), 40)
    ber_lo = float(np.asarray(lo.bit_errors).mean()) / 2040
    ber_hi = float(np.asarray(hi.bit_errors).mean()) / 2040
    assert ber_lo < thr * 0.6 * 0.25      # decoding helps well below
    assert ber_hi > thr                   # stuck above


# ---------------------------------------------------------------------------
# Irregular-ensemble DE (capability extension; self-contained anchors)
# ---------------------------------------------------------------------------

def test_irregular_degenerate_equals_regular():
    """Degenerate (lambda, rho) must reproduce the regular recursion and
    threshold exactly."""
    from iib_project_ldpc_codes_tpu.utils.theory import (
        calc_threshold, density_evolution, irregular_density_evolution,
        irregular_threshold, regular_lam_rho)

    for dv, dc in [(3, 6), (4, 8)]:
        lam, rho = regular_lam_rho(dv, dc)
        a = density_evolution(0.4, 30, dv, dc)
        b = irregular_density_evolution(0.4, lam, rho, 30)
        assert np.allclose(a, b, rtol=0, atol=1e-14)
        assert abs(irregular_threshold(lam, rho, 1e-7)
                   - calc_threshold(dv, dc, 1e-7)) < 1e-6


def test_irregular_design_rate():
    from iib_project_ldpc_codes_tpu.utils.theory import (design_rate,
                                                         regular_lam_rho)

    lam, rho = regular_lam_rho(3, 6)
    assert abs(design_rate(lam, rho) - 0.5) < 1e-12
    # lambda(x) = 0.5x + 0.5x^2, rho(x) = x^5:
    # rate = 1 - (1/6)/(0.5/2 + 0.5/3) = 1 - 2/5
    assert abs(design_rate([0, 0.5, 0.5], [0, 0, 0, 0, 0, 1.0])
               - 0.6) < 1e-12


def test_irregular_threshold_bounds():
    """eps* <= Shannon limit (1 - rate) and <= the stability limit, for a
    spread of irregular pairs; thresholds are strictly positive."""
    from iib_project_ldpc_codes_tpu.utils.theory import (
        design_rate, irregular_threshold, stability_limit)

    pairs = [
        ([0, 0.5, 0.5], [0, 0, 0, 0, 0, 1.0]),
        ([0, 0.3, 0.3, 0.4], [0, 0, 0, 0, 0.5, 0.5]),
        ([0, 0.0, 1.0], [0, 0, 0, 0, 0, 1.0]),     # (3,6) regular
        ([0, 0.2, 0.0, 0.8], [0, 0, 0, 0, 0, 0, 0, 1.0]),
    ]
    for lam, rho in pairs:
        thr = irregular_threshold(lam, rho, 1e-7)
        assert 0.0 < thr < 1.0
        assert thr <= 1.0 - design_rate(lam, rho) + 1e-6   # Shannon
        assert thr <= stability_limit(lam, rho) + 1e-6      # stability


def test_irregular_beats_regular_at_same_rate():
    """A touch of degree-2/high-degree mixture beats (3,6) regular at
    rate 1/2 -- the reason production codes are irregular.  The pair
    below is rate-1/2 by construction."""
    from iib_project_ldpc_codes_tpu.utils.theory import (
        calc_threshold, design_rate, irregular_threshold)

    # lambda(x) = a x + (1-a) x^3 with a chosen for rate 1/2 against
    # rho(x) = x^5: need int(lam) = 2*int(rho) = 1/3
    # a/2 + (1-a)/4 = 1/3  =>  a = 1/3
    lam = [0, 1/3, 0, 2/3]
    rho = [0, 0, 0, 0, 0, 1.0]
    assert abs(design_rate(lam, rho) - 0.5) < 1e-12
    thr = irregular_threshold(lam, rho, 1e-7)
    assert thr > calc_threshold(3, 6) + 1e-3


def test_irregular_validation_errors():
    import pytest

    from iib_project_ldpc_codes_tpu.utils.theory import (
        irregular_threshold)

    with pytest.raises(ValueError):
        irregular_threshold([0.1, 0.9], [0, 0, 1.0])   # c0 != 0
    with pytest.raises(ValueError):
        irregular_threshold([0, 0.5, 0.4], [0, 0, 1.0])  # sum != 1


def test_gallager_b_reduces_to_a():
    """b = dv-1 IS Gallager-A: identical trajectory and threshold."""
    from iib_project_ldpc_codes_tpu.utils.theory import (
        gallager_a_density_evolution, gallager_a_threshold,
        gallager_b_density_evolution, gallager_b_threshold)

    a = gallager_a_density_evolution(0.03, 50, 3, 6)
    b = gallager_b_density_evolution(0.03, 50, 3, 6, b=2)
    assert b == pytest.approx(a, rel=1e-12)  # same recursion, float order
    assert gallager_b_threshold(3, 6, 2) == pytest.approx(
        gallager_a_threshold(3, 6), abs=1e-6)


def test_gallager_b_thresholds_and_optimal_rule():
    """Computed anchors for (4,8): b=3 beats b=2, the optimal switching
    rule beats any fixed b, and (5,10)'s optimal rule shows the biggest
    gain (early iterations want a lower flip threshold)."""
    from iib_project_ldpc_codes_tpu.utils.theory import gallager_b_threshold

    t2 = gallager_b_threshold(4, 8, 2)
    t3 = gallager_b_threshold(4, 8, 3)
    topt = gallager_b_threshold(4, 8)
    assert t3 == pytest.approx(0.04757, abs=2e-4)
    assert topt == pytest.approx(0.05165, abs=2e-4)
    assert t2 < t3 < topt
    for b in (2, 3, 4):
        assert gallager_b_threshold(5, 10, b) <= \
            gallager_b_threshold(5, 10) + 1e-9


def test_gallager_b_de_monotone_below_threshold():
    from iib_project_ldpc_codes_tpu.utils.theory import (
        gallager_b_density_evolution, gallager_b_threshold)

    thr = gallager_b_threshold(4, 8, 3)
    traj = gallager_b_density_evolution(thr - 0.01, 300, 4, 8, b=3)
    assert traj[-1] < 1e-9
    stuck = gallager_b_density_evolution(thr + 0.01, 300, 4, 8, b=3)
    assert stuck[-1] > 0.01


def test_awgn_ga_threshold_anchors():
    """Gaussian-approximation DE recovers the published GA thresholds:
    sigma*(3,6) ~= 0.8747 and sigma*(4,8) ~= 0.8324 (Chung, Richardson &
    Urbanke 2001) -- both ~= 0.88/0.83, computed here, not cited."""
    from iib_project_ldpc_codes_tpu.utils.theory import (
        awgn_threshold_sigma_ga)

    assert awgn_threshold_sigma_ga(3, 6) == pytest.approx(0.8747, abs=2e-3)
    assert awgn_threshold_sigma_ga(4, 8) == pytest.approx(0.8324, abs=2e-3)


def test_awgn_ga_de_trajectory():
    from iib_project_ldpc_codes_tpu.utils.theory import awgn_gaussian_de

    below = awgn_gaussian_de(0.8, 100, 3, 6)
    assert below[0] == pytest.approx(0.1056, abs=1e-3)  # Q(1/sigma)
    assert below[-1] < 1e-12
    assert all(b <= a + 1e-15 for a, b in zip(below, below[1:]))
    above = awgn_gaussian_de(0.95, 100, 3, 6)
    assert above[-1] > 0.01


def test_awgn_population_de_brackets_exact_threshold():
    """Sampled DE: decodes at sigma=0.85 (below the exact threshold
    0.8790), stuck at sigma=0.92 (above) -- small-population smoke; the
    full-population run recovering 0.879+-0.003 is recorded in
    docs/VALIDATION.md."""
    from iib_project_ldpc_codes_tpu.utils.theory import awgn_population_de

    lo = awgn_population_de(0.85, 200, 3, 6, population=1 << 16, seed=3)
    assert lo[-1] < 1e-4
    hi = awgn_population_de(0.92, 200, 3, 6, population=1 << 16, seed=3)
    assert hi[-1] > 0.02


def test_irregular_modified_de_degenerate_matches_regular():
    from iib_project_ldpc_codes_tpu.utils.theory import (
        irregular_modified_density_evolution, modified_density_evolution,
        regular_lam_rho)

    lam, rho = regular_lam_rho(3, 6)
    a = modified_density_evolution(0.4, 25, 3, 6)
    b = irregular_modified_density_evolution(0.4, lam, rho, 25)
    assert b == pytest.approx(a, rel=1e-12)


def test_irregular_mc_ber_per_iteration_tracks_de():
    """Large-n irregular simulation's per-iteration bit erasure rate
    follows the irregular bit-erasure DE down to finite-size floor."""
    import numpy as np

    from iib_project_ldpc_codes_tpu.parallel.montecarlo import run_simulation
    from iib_project_ldpc_codes_tpu.utils.config import SimulationConfig
    from iib_project_ldpc_codes_tpu.utils.theory import (
        irregular_modified_density_evolution)

    lam = [0, 1 / 3, 0, 2 / 3]
    rho = [0, 0, 0, 0, 0, 1.0]
    eps = 0.40  # below the 0.4526 irregular threshold
    cfg = SimulationConfig(channel="BEC", channel_param=eps, n=8192,
                           lam=lam, rho=rho, decoder="bp", iterations=12,
                           num_tests=512, batch=512,
                           max_block_errors=10**9, seed=2,
                           code_mode="ensemble")
    res = run_simulation(cfg)
    mc = np.asarray(res.error_rate_per_iteration)
    de = np.asarray(irregular_modified_density_evolution(eps, lam, rho, 12))
    k = min(len(mc), len(de))
    # early/mid iterations track DE within MC noise + finite-n bias;
    # ignore the tail where the small-stopping-set floor dominates
    for t in range(1, min(k, 8)):
        assert mc[t] == pytest.approx(de[t], rel=0.25, abs=2e-3)


def test_optimize_lambda_recovers_known_optima():
    """The LP designer reproduces known optimal ensembles: at dv_max=3 /
    rate 1/2 / rho=x^5 the optimum IS (3,6)-regular; at dv_max=4 it is
    exactly the (1/3)x + (2/3)x^3 pair used throughout the test suite."""
    from iib_project_ldpc_codes_tpu.utils.theory import (
        calc_threshold, irregular_threshold, optimize_lambda_for_rate)

    rho = [0, 0, 0, 0, 0, 1.0]
    lam3, eps3 = optimize_lambda_for_rate(rho, 3, 0.5)
    assert abs(eps3 - calc_threshold(3, 6)) < 2e-3
    assert lam3[2] > 0.99                        # all mass on degree 3

    lam4, eps4 = optimize_lambda_for_rate(rho, 4, 0.5)
    assert abs(eps4 - 0.45265) < 2e-3
    assert lam4[1] == pytest.approx(1 / 3, abs=5e-3)
    assert lam4[3] == pytest.approx(2 / 3, abs=5e-3)


def test_optimize_lambda_improves_with_dv_max_and_verifies():
    """Thresholds increase with dv_max toward the Shannon limit, and the
    grid-LP threshold agrees with the exact DE bisection on the designed
    lambda."""
    from iib_project_ldpc_codes_tpu.utils.theory import (
        design_rate, irregular_threshold, optimize_lambda_for_rate)

    rho = [0, 0, 0, 0, 0, 1.0]
    prev = 0.0
    for dv_max in (4, 6, 8):
        lam, eps = optimize_lambda_for_rate(rho, dv_max, 0.5)
        lam = [float(v) for v in lam]
        assert design_rate(lam, rho) == pytest.approx(0.5, abs=1e-3)
        thr = irregular_threshold(lam, rho, 1e-6)
        assert thr == pytest.approx(eps, abs=2e-3)  # LP grid vs exact DE
        assert thr > prev - 1e-9
        prev = thr
    assert prev > 0.478                      # 96% of the 0.5 Shannon limit
    assert prev < 0.5                        # never beats capacity


def test_optimized_ensemble_simulates_end_to_end():
    """Design -> sample -> decode: the dv_max=6 LP-optimised ensemble
    beats the dv_max=4 pair in Monte Carlo at an eps between their
    thresholds (the full design loop, closed in simulation)."""
    from iib_project_ldpc_codes_tpu.parallel.montecarlo import run_simulation
    from iib_project_ldpc_codes_tpu.utils.config import SimulationConfig
    from iib_project_ldpc_codes_tpu.utils.theory import (
        optimize_lambda_for_rate)

    rho = [0, 0, 0, 0, 0, 1.0]
    lam6, _ = optimize_lambda_for_rate(rho, 6, 0.5)
    lam6 = [float(v) for v in lam6]
    eps = 0.46  # above the dv_max=4 threshold 0.4526, below dv_max=6's 0.4775

    def run(lam):
        cfg = SimulationConfig(channel="BEC", channel_param=eps, n=2048,
                               lam=lam, rho=rho, decoder="bp",
                               iterations=80, num_tests=2048, batch=512,
                               max_block_errors=10**9, seed=37,
                               code_mode="ensemble")
        return run_simulation(cfg)

    opt = run(lam6)
    hand = run([0, 1 / 3, 0, 2 / 3])
    assert opt.bit_error_rate < 0.3 * hand.bit_error_rate


def test_awgn_minsum_population_de_brackets_its_threshold():
    """Sampled min-sum DE: decodes at sigma=0.79 (below the computed
    min-sum threshold 0.823), stuck at 0.86 (above it, yet below the
    sum-product 0.879 -- the min-sum penalty region)."""
    from iib_project_ldpc_codes_tpu.utils.theory import (
        awgn_population_de_minsum)

    lo = awgn_population_de_minsum(0.79, 200, 3, 6, population=1 << 16,
                                   seed=3)
    assert lo[-1] < 1e-4
    hi = awgn_population_de_minsum(0.86, 200, 3, 6, population=1 << 16,
                                   seed=3)
    assert hi[-1] > 0.02


def test_awgn_int8_minsum_de_near_float_minsum():
    """int8 quantisation at the default scale costs almost nothing in
    DE: the quantised trajectory decodes wherever float min-sum does,
    comfortably below the computed threshold."""
    from iib_project_ldpc_codes_tpu.utils.theory import (
        awgn_population_de_minsum)

    f = awgn_population_de_minsum(0.79, 200, 3, 6, population=1 << 16,
                                  seed=5)
    q = awgn_population_de_minsum(0.79, 200, 3, 6, population=1 << 16,
                                  seed=5, int8_scale=4.0)
    assert f[-1] < 1e-4 and q[-1] < 1e-4


def test_irregular_awgn_ga_thresholds():
    """Irregular Gaussian-approximation AWGN DE: degenerate pairs
    reproduce the regular GA threshold; the rate-1/2 irregular pair
    beats (3,6)-regular on AWGN too (sigma* ~ 0.904 vs 0.8747, matching
    an independent irregular population-DE bracket of 0.88..0.92)."""
    from iib_project_ldpc_codes_tpu.utils.theory import (
        awgn_threshold_sigma_ga, irregular_awgn_threshold_sigma_ga,
        regular_lam_rho)

    lam, rho = regular_lam_rho(3, 6)
    assert irregular_awgn_threshold_sigma_ga(lam, rho) == pytest.approx(
        awgn_threshold_sigma_ga(3, 6), abs=2e-3)
    thr = irregular_awgn_threshold_sigma_ga([0, 1 / 3, 0, 2 / 3],
                                            [0, 0, 0, 0, 0, 1.0])
    assert thr == pytest.approx(0.904, abs=3e-3)
    assert thr > awgn_threshold_sigma_ga(3, 6) + 0.02


def test_irregular_awgn_ga_de_trajectory():
    from iib_project_ldpc_codes_tpu.utils.theory import (
        irregular_awgn_gaussian_de)

    lam = [0, 1 / 3, 0, 2 / 3]
    rho = [0, 0, 0, 0, 0, 1.0]
    below = irregular_awgn_gaussian_de(0.85, lam, rho, 200)
    assert below[-1] < 1e-8
    above = irregular_awgn_gaussian_de(0.97, lam, rho, 200)
    assert above[-1] > 1e-3


def test_optimize_lambda_awgn_recovers_known_optima():
    """The AWGN (GA) LP designer mirrors the BEC one: dv_max=3 recovers
    (3,6)-regular and dv_max=4 recovers the (1/3)x+(2/3)x^3 pair (which
    is therefore optimal at dv_max=4 on BOTH channels); dv_max=6 climbs
    to sigma* ~ 0.920, verified by the irregular GA threshold."""
    from iib_project_ldpc_codes_tpu.utils.theory import (
        awgn_threshold_sigma_ga, design_rate,
        irregular_awgn_threshold_sigma_ga, optimize_lambda_awgn_for_rate)

    rho = [0, 0, 0, 0, 0, 1.0]
    lam3, sig3 = optimize_lambda_awgn_for_rate(rho, 3, 0.5)
    assert sig3 == pytest.approx(awgn_threshold_sigma_ga(3, 6), abs=3e-3)
    assert lam3[2] > 0.99

    lam4, sig4 = optimize_lambda_awgn_for_rate(rho, 4, 0.5)
    assert lam4[1] == pytest.approx(1 / 3, abs=5e-3)
    assert lam4[3] == pytest.approx(2 / 3, abs=5e-3)
    assert sig4 == pytest.approx(0.904, abs=3e-3)

    lam6, sig6 = optimize_lambda_awgn_for_rate(rho, 6, 0.5)
    lam6 = [float(v) for v in lam6]
    assert design_rate(lam6, rho) == pytest.approx(0.5, abs=2e-3)
    ver = irregular_awgn_threshold_sigma_ga(lam6, rho)
    assert ver == pytest.approx(sig6, abs=3e-3)
    assert ver > sig4 + 0.01


def test_fit_waterfall_alpha_recovers_regular_law():
    """Synthetic FERs generated from the (3,6) scaling law must give back
    (alpha, beta) exactly (the fit is linear after the probit)."""
    import numpy as np

    thr = theory.calc_threshold(3, 6)
    alpha = theory.calculate_alpha(thr, 3, 6)
    beta = theory.BETA_3_6
    pts = []
    for n in (4096, 8192, 16384, 65536):
        for eps in np.linspace(thr - 0.02, thr - 0.002, 5):
            fer = float(theory.waterfall_block_error_fitted(
                n, eps, thr, alpha, beta))
            pts.append((n, eps, fer))
    a_hat, b_hat = theory.fit_waterfall_alpha(pts, thr)
    assert a_hat == pytest.approx(alpha, rel=1e-6)
    assert b_hat == pytest.approx(beta, rel=1e-5)
    # beta pinned to zero still recovers the slope on shift-free data
    pts0 = [(n, e, float(theory.waterfall_block_error_fitted(
        n, e, thr, alpha, 0.0))) for n, e, _ in pts]
    a0, b0 = theory.fit_waterfall_alpha(pts0, thr, fit_shift=False)
    assert a0 == pytest.approx(alpha, rel=1e-6) and b0 == 0.0


def test_fit_waterfall_alpha_drops_saturated_points():
    import numpy as np

    thr = theory.calc_threshold(3, 6)
    alpha = theory.calculate_alpha(thr, 3, 6)
    pts = [(n, e, float(theory.waterfall_block_error_fitted(
        n, e, thr, alpha, 0.0)))
        for n in (8192, 32768) for e in np.linspace(thr - 0.015, thr, 4)]
    pts += [(8192, 0.2, 0.0), (8192, 0.6, 1.0)]   # saturated: ignored
    a_hat, _ = theory.fit_waterfall_alpha(pts, thr)
    assert a_hat == pytest.approx(alpha, rel=1e-6)
    with pytest.raises(ValueError):
        theory.fit_waterfall_alpha([(8192, 0.2, 0.0)], thr)


def test_irregular_alpha_fit_is_n_stable_on_hardware_data():
    """The fitted irregular scaling slope must be n-stable: per-n refits
    of the measured waterfalls (docs/data/irregular_scaling.json) stay
    within 15% of the joint fit.  Skips when the measured
    data is not present (fresh clone before the hardware run)."""
    import json
    import os

    path = os.path.join(os.path.dirname(__file__), "..", "docs", "data",
                        "irregular_scaling.json")
    if not os.path.exists(path):
        pytest.skip("hardware scaling data not generated yet")
    with open(path) as f:
        doc = json.load(f)
    alpha = doc["alpha"]
    assert alpha > 0
    per_n = doc["alpha_per_n"]
    assert len(per_n) >= 3
    for n, a in per_n.items():
        assert abs(a / alpha - 1.0) < 0.15, (n, a, alpha)
    # the law must actually describe the measured points: refit from the
    # raw (n, eps, fer) rows and reproduce the recorded joint alpha
    pts = [(r["n"], r["eps"], r["fer"]) for r in doc["points"]]
    a2, b2 = theory.fit_waterfall_alpha(pts, doc["threshold"])
    assert a2 == pytest.approx(alpha, rel=1e-6)
    assert b2 == pytest.approx(doc["beta"], rel=1e-6)
    # and the 3-parameter fit MEASURES the ensemble threshold from the
    # waterfalls alone: within 5e-4 of irregular DE (measured: 3e-4)
    _, _, thr_hat = theory.fit_waterfall_full(pts)
    assert thr_hat == pytest.approx(doc["threshold"], abs=5e-4)


def test_fit_recovers_closed_form_alpha_from_measured_data():
    """Fitting the round-3 MEASURED regular waterfalls (n=1e5/1e6
    edge-sharded Monte Carlo, docs/VALIDATION.md) must recover the
    closed-form alpha(3,6) -- the end-to-end legitimacy check for the
    irregular alpha measurement route (which has no closed form to
    compare against)."""
    thr = theory.calc_threshold(3, 6)
    alpha_cf = theory.calculate_alpha(thr, 3, 6)
    pts = ([(100_000, e, f) for e, f in zip(
        [0.4250, 0.4275, 0.4290, 0.4310],
        [0.0093, 0.1655, 0.4685, 0.8364])] +
        [(1_000_000, e, f) for e, f in zip(
            [0.4280, 0.4288, 0.4292, 0.4298],
            [0.0068, 0.1299, 0.3818, 0.7852])])
    a, b = theory.fit_waterfall_alpha(pts, thr)
    assert a == pytest.approx(alpha_cf, rel=0.02)   # measured: 0.2% off
    # beta is weakly identified at n >= 1e5 (the n^(-2/3) shift is
    # ~2e-4 in eps) -- only sanity-bound it
    assert 0.0 < b < 1.5


def test_fit_waterfall_full_recovers_threshold():
    """The 3-parameter fit must recover (alpha, beta, eps*) exactly from
    synthetic law data, and measure eps*(3,6) from round-3's real
    hardware FERs to ~1e-4."""
    import numpy as np

    thr = theory.calc_threshold(3, 6)
    alpha = theory.calculate_alpha(thr, 3, 6)
    beta = theory.BETA_3_6
    pts = [(n, e, float(theory.waterfall_block_error_fitted(
        n, e, thr, alpha, beta)))
        for n in (2048, 8192, 65536)
        for e in np.linspace(thr - 0.02, thr - 0.002, 4)]
    a, b, t = theory.fit_waterfall_full(pts)
    assert a == pytest.approx(alpha, rel=1e-6)
    assert b == pytest.approx(beta, rel=1e-5)
    assert t == pytest.approx(thr, abs=1e-9)
    # measured hardware data (round 3, n=1e5/1e6 edge-sharded MC)
    real = ([(100_000, e, f) for e, f in zip(
        [0.4250, 0.4275, 0.4290, 0.4310],
        [0.0093, 0.1655, 0.4685, 0.8364])] +
        [(1_000_000, e, f) for e, f in zip(
            [0.4280, 0.4288, 0.4292, 0.4298],
            [0.0068, 0.1299, 0.3818, 0.7852])])
    a2, _, t2 = theory.fit_waterfall_full(real)
    assert t2 == pytest.approx(thr, abs=3e-4)   # measured: ~1e-4 off
    assert a2 == pytest.approx(alpha, rel=0.1)
    with pytest.raises(ValueError):
        theory.fit_waterfall_full([(8192, 0.42, 0.3), (8192, 0.43, 0.5)])


def test_awgn_alpha_fit_hardware_data():
    """Gated on the measured AWGN scaling data: the fitted sigma* must
    agree with the population-DE threshold (0.879 +- 0.003) and the
    per-n alpha must be n-stable."""
    import json
    import os

    base = os.path.join(os.path.dirname(__file__), "..", "docs", "data")
    any_found = False
    for fname in ("awgn_scaling.json", "awgn_scaling_int8.json"):
        path = os.path.join(base, fname)
        if not os.path.exists(path):
            continue
        any_found = True
        with open(path) as f:
            doc = json.load(f)
        assert doc["sigma_star_fit"] == pytest.approx(
            doc["sigma_star_de"], abs=0.008), fname
        per_n = doc["alpha_per_n"]
        assert len(per_n) >= 3
        for n, a in per_n.items():
            assert abs(a / doc["alpha3"] - 1.0) < 0.2, (fname, n, a)
    if not any_found:
        pytest.skip("hardware AWGN scaling data not generated yet")


def test_bsc_alpha_fit_hardware_data():
    """Gated on the measured BSC Gallager-A scaling data: fitted p*
    within 1e-3 of DE, per-n alpha n-stable."""
    import json
    import os

    path = os.path.join(os.path.dirname(__file__), "..", "docs", "data",
                        "bsc_scaling.json")
    if not os.path.exists(path):
        pytest.skip("hardware BSC scaling data not generated yet")
    with open(path) as f:
        doc = json.load(f)
    assert doc["p_star_fit"] == pytest.approx(doc["p_star_de"], abs=1e-3)
    for n, a in doc["alpha_per_n"].items():
        assert abs(a / doc["alpha3"] - 1.0) < 0.1, (n, a)
