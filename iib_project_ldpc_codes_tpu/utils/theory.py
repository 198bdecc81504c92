"""Closed-form LDPC/BEC theory: density evolution, thresholds, scaling laws.

Pure host-side numpy/python -- these are the regression anchors and
acceptance oracles for the Monte Carlo engine (SURVEY.md section 6):

  * DE threshold eps*(3,6) ~= 0.4294375, eps*(4,8) ~= 0.3834453
    (test_de_threshold.py:7-28)
  * scaling parameter alpha(3,6) ~= 0.5595 with y* ~= 0.7799, x* ~= 0.2612
    (finite_length_scaling_calculation.py:9-21)
  * finite-size shift beta(3,6) = 0.616949 (tools/density_evolution.py:4)
  * waterfall P_block ~= Phi(-sqrt(n)(eps*-eps)/alpha)
    (finite_length_scaling_calculation.py:41-43)
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import List

import numpy as np

#: finite-size threshold shift for the (3,6) ensemble
#: (tools/density_evolution.py:4).  The single default everywhere a beta
#: is needed; the reference's second variant is kept below as an explicit
#: opt-in, never a silent default.
BETA_3_6 = 0.616949

#: the reference's commented waterfall-shift variant
#: (finite_length_scaling_calculation.py:40).  Pass explicitly as
#: ``beta=BETA_3_6_WATERFALL`` to reproduce that curve exactly.
BETA_3_6_WATERFALL = 0.616045


# ---------------------------------------------------------------------------
# Density evolution (tools/density_evolution.py:9-28)
# ---------------------------------------------------------------------------

def density_evolution(erasure_prob: float, iterations: int, dv: int, dc: int,
                      threshold: float = 0.0) -> List[float]:
    """Edge-erasure DE recursion x_{t+1} = eps(1-(1-x_t)^(dc-1))^(dv-1).

    Returns the trajectory [eps, x_1, x_2, ...], truncated when the value
    drops to ``threshold`` (tools/density_evolution.py:9-16).
    """
    results = [erasure_prob]
    x = erasure_prob
    for _ in range(iterations):
        x = erasure_prob * (1.0 - (1.0 - x) ** (dc - 1)) ** (dv - 1)
        if x <= threshold:
            break
        results.append(x)
    return results


def modified_density_evolution(erasure_prob: float, iterations: int, dv: int,
                               dc: int, threshold: float = 0.0
                               ) -> List[float]:
    """Bit-erasure DE: tracks eps(1-(1-x)^(dc-1))^dv alongside the edge
    recursion -- the curve overlaid on simulated BER-vs-iteration plots
    (tools/density_evolution.py:18-28, used at tools/plotting.py:86)."""
    results = [erasure_prob]
    x = erasure_prob
    for _ in range(iterations):
        inner = 1.0 - (1.0 - x) ** (dc - 1)
        bit_prob = erasure_prob * inner ** dv
        x = erasure_prob * inner ** (dv - 1)
        if bit_prob <= threshold:
            break
        results.append(bit_prob)
    return results


def finite_length_density_evolution(erasure_prob: float, iterations: int,
                                    n: int, dv: int = 3, dc: int = 6,
                                    threshold: float = 0.0,
                                    beta: float = BETA_3_6) -> List[float]:
    """DE at the finite-size-shifted erasure probability eps + beta n^(-2/3)
    (tools/density_evolution.py:3-6)."""
    return modified_density_evolution(erasure_prob + beta * n ** (-2.0 / 3.0),
                                      iterations, dv, dc, threshold)


# ---------------------------------------------------------------------------
# DE threshold (test_de_threshold.py:7-28)
# ---------------------------------------------------------------------------

def below_threshold(erasure_prob: float, dv: int, dc: int,
                    max_iterations: int = 100_000,
                    tolerance: float = 1e-6) -> bool:
    """Does DE drive the erasure probability below ``tolerance``?

    Same fixed point test as the reference (test_de_threshold.py:7-15) but
    with convergence early-exit instead of a fixed 100000-iteration burn.
    """
    x = erasure_prob
    for _ in range(max_iterations):
        new_x = erasure_prob * (1.0 - (1.0 - x) ** (dc - 1)) ** (dv - 1)
        if new_x < tolerance:
            return True
        # monotone decreasing recursion: stagnation => stuck above tolerance
        if x - new_x < 1e-15:
            return False
        x = new_x
    return x < tolerance


@lru_cache(maxsize=None)
def calc_threshold(dv: int, dc: int, precision: float = 1e-9) -> float:
    """BP threshold eps*(dv,dc) by bisection (test_de_threshold.py:17-28).

    Verified anchors: eps*(3,6) ~= 0.4294375, eps*(4,8) ~= 0.3834453.
    """
    lo, hi = 0.0, 1.0
    while hi - lo > precision:
        mid = 0.5 * (lo + hi)
        if below_threshold(mid, dv, dc):
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


# ---------------------------------------------------------------------------
# Finite-length scaling (finite_length_scaling_calculation.py:9-43,
# peeling_decoder.py:84-87)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def threshold_y(threshold_erasure: float, dv: int, dc: int,
                tol: float = 1e-6) -> float:
    """Fixed point y* of y = 1-(1-eps* y^(dv-1))^(dc-1)
    (finite_length_scaling_calculation.py:10-16)."""
    prev, y = 0.0, 1.0
    while abs(y - prev) > tol:
        prev = y
        y = 1.0 - (1.0 - threshold_erasure * y ** (dv - 1)) ** (dc - 1)
    return y


def threshold_x(threshold_erasure: float, dv: int, dc: int) -> float:
    """x* = eps* (y*)^(dv-1) (finite_length_scaling_calculation.py:20)."""
    return threshold_erasure * threshold_y(threshold_erasure, dv, dc) ** (dv - 1)


def calculate_alpha(threshold: float, dv: int, dc: int) -> float:
    """Scaling parameter alpha = eps* sqrt(((dv-1)/dv)(1/x* - 1/y*))
    (finite_length_scaling_calculation.py:18-21).  alpha(3,6) ~= 0.5595."""
    y = threshold_y(threshold, dv, dc)
    x = threshold * y ** (dv - 1)
    return threshold * math.sqrt(((dv - 1) / dv) * (1.0 / x - 1.0 / y))


def _norm_cdf(z):
    return 0.5 * np.ones_like(z) * (1.0 + np.vectorize(math.erf)(
        np.asarray(z) / math.sqrt(2.0)))


def waterfall_block_error(n, erasure_probs, dv: int = 3, dc: int = 6,
                          finite_size_shift: bool = False,
                          beta: float = BETA_3_6) -> np.ndarray:
    """Scaling-law waterfall P_block(n, eps) = Phi(-sqrt(n)(eps*-eps)/alpha)
    (finite_length_scaling_calculation.py:41-43; optional beta n^(-2/3)
    shift).  ``beta`` defaults to the repo-wide :data:`BETA_3_6`; pass
    ``beta=BETA_3_6_WATERFALL`` for the reference's commented variant
    (finite_length_scaling_calculation.py:40)."""
    erasure_probs = np.asarray(erasure_probs, float)
    thr = calc_threshold(dv, dc)
    alpha = calculate_alpha(thr, dv, dc)
    shift = beta * float(n) ** (-2.0 / 3.0) if finite_size_shift else 0.0
    z = math.sqrt(n) * (thr - erasure_probs - shift)
    return _norm_cdf(-z / alpha)


def critical_point_variance(n: int, erasure_prob: float, dv: int, dc: int
                            ) -> float:
    """Variance of the degree-1 check count at the critical point
    (peeling_decoder.py:225)."""
    thr = calc_threshold(dv, dc)
    alpha = calculate_alpha(thr, dv, dc)
    y = threshold_y(thr, dv, dc)
    return n * dv ** 2 * (alpha * thr * (dc - 1) * y ** (2 * dv - 2)
                          * (1.0 - thr * y ** (dv - 1)) ** (dc - 2)) ** 2


# ---------------------------------------------------------------------------
# Peeling drift / critical point (peeling_decoder.py:101-123,
# test_peeling_decoder_path.py:8-14, test_critical_point_calculator.py)
# ---------------------------------------------------------------------------

def peeling_drift_normalized(erasure_prob: float, dv: int, dc: int, y
                             ) -> np.ndarray:
    """Expected fraction-of-edges drift r(y) = eps y^(dv-1)
    (y - 1 + (1 - eps y^(dv-1))^(dc-1)) (test_peeling_decoder_path.py:12-14).
    ``y`` is the fraction of *unresolved* erased variables remaining."""
    y = np.asarray(y, float)
    x = erasure_prob * y ** (dv - 1)
    return x * (y - 1.0 + (1.0 - x) ** (dc - 1))


def peeling_drift(erasure_prob: float, dv: int, dc: int, n: int, steps
                  ) -> np.ndarray:
    """Expected degree-1 check count after ``steps`` peeling steps remain
    -- the reference's ``dv*n*f(...)`` in absolute time units
    (peeling_decoder.py:101-107): steps counts down from n*eps, and
    y = (1 - steps/(eps n))^(1/dv)."""
    steps = np.asarray(steps, float)
    y = (1.0 - steps / (erasure_prob * n)) ** (1.0 / dv)
    return dv * n * peeling_drift_normalized(erasure_prob, dv, dc, y)


def irregular_peeling_drift_normalized(erasure_prob: float, lam, rho, x
                                       ) -> np.ndarray:
    """Expected degree-1 fraction-of-edges drift for a (lambda, rho)
    ensemble: r1(x) = eps lambda(x) (x - 1 + rho(1 - eps lambda(x))).

    The irregular generalisation of :func:`peeling_drift_normalized`
    (LMSS "Efficient Erasure Correcting Codes" differential-equation
    analysis); with the degenerate distributions of
    :func:`regular_lam_rho` it reduces to the regular formula exactly
    (lambda(x) = x^(dv-1), rho(z) = z^(dc-1)).  ``x`` runs 1 -> 0 over
    the peel; the unresolved-erased-variable fraction at time x is
    eps * L(x) with L the node-perspective variable polynomial
    (:func:`node_perspective`), generalising the regular y^dv mapping.

    Sanity anchor at x=1 (before any peel): r1(1) = eps rho(1-eps), the
    direct expected fraction of edges in degree-1 checks after stripping
    the received bits.
    """
    lam = _poly_check(lam, "lam")
    rho = _poly_check(rho, "rho")
    x = np.asarray(x, float)
    lx = np.polyval(lam[::-1], x)
    return erasure_prob * lx * (
        x - 1.0 + np.polyval(rho[::-1], 1.0 - erasure_prob * lx))


def _node_poly_val(lam, x):
    """L(x) = sum_d L_d x^d with L the node-perspective distribution."""
    node = node_perspective(lam)
    x = np.asarray(x, float)
    return sum(nd * x ** (i + 1) for i, nd in enumerate(node))


def _invert_node_poly(lam, target) -> np.ndarray:
    """x with L(x) = target (L monotone increasing on [0,1]); vectorised
    bisection."""
    target = np.asarray(target, float)
    lo = np.zeros_like(target)
    hi = np.ones_like(target)
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        below = _node_poly_val(lam, mid) < target
        lo = np.where(below, mid, lo)
        hi = np.where(below, hi, mid)
    return 0.5 * (lo + hi)


def irregular_peeling_drift(erasure_prob: float, lam, rho, n: int, steps,
                            avg_dv: float | None = None) -> np.ndarray:
    """Expected degree-1 check COUNT after ``steps`` peels of a length-n
    (lambda, rho) code -- the irregular analogue of :func:`peeling_drift`.

    Each peel resolves one variable, so the unresolved fraction after s
    peels is eps - s/n = eps L(x); inverting L gives the x to evaluate
    :func:`irregular_peeling_drift_normalized` at, scaled by the edge
    count E = n / int(lambda).
    """
    lam_c = _poly_check(lam, "lam")
    if avg_dv is None:
        avg_dv = 1.0 / float(sum(c / (i + 1)
                                 for i, c in enumerate(lam_c)))
    steps = np.asarray(steps, float)
    frac_left = np.clip(1.0 - steps / (erasure_prob * n), 0.0, 1.0)
    x = _invert_node_poly(lam, frac_left)
    return n * avg_dv * irregular_peeling_drift_normalized(
        erasure_prob, lam, rho, x)


def irregular_critical_x(lam, rho, erasure_prob: float | None = None
                         ) -> float:
    """The peeling-time x where the drift is at its interior minimum
    (at eps = eps* the minimum touches zero -- the critical point of the
    irregular R-process; regular inputs reproduce the tangency point of
    :func:`calculate_crit_point` in the x-coordinate y*).

    ``erasure_prob`` defaults to the ensemble's BP threshold.
    """
    if erasure_prob is None:
        erasure_prob = irregular_threshold(lam, rho, 1e-7)
    xs = np.linspace(1e-6, 1.0 - 1e-6, 200_001)
    r = irregular_peeling_drift_normalized(erasure_prob, lam, rho, xs)
    # r1 -> 0 at x=0 (completion) too, so look for the INTERIOR local
    # minimum -- the near-threshold dip where trajectories die; at
    # eps = eps* it touches zero (tangency).  Largest-x local minimum
    # wins (the first bottleneck the decoder must survive).
    interior = (r[1:-1] <= r[:-2]) & (r[1:-1] <= r[2:])
    idx = np.nonzero(interior)[0]
    if idx.size == 0:
        return float(xs[int(np.argmin(r))])
    return float(xs[idx[-1] + 1])


def fit_waterfall_full(points):
    """Fit (alpha, beta, threshold) jointly from measured waterfalls.

    Same probit-linear structure as :func:`fit_waterfall_alpha` with the
    threshold as a third unknown:

        sqrt(n) p_i = alpha z_i - beta n^(-1/6) + theta sqrt(n)

    (p = the channel parameter).  Needs points at >= 2 distinct n (the
    sqrt(n) and n^(-1/6) columns must be distinguishable).  Returns
    ``(alpha, beta, threshold_hat)`` -- a MEASUREMENT of the ensemble
    threshold from finite-length waterfalls alone, cross-checkable
    against density evolution (tests: recovers eps*(3,6) from the
    measured n=1e5/1e6 hardware FERs).
    """
    pts = [(float(n), float(e), float(f)) for n, e, f in points
           if 0.0 < f < 1.0]
    if len({n for n, _, _ in pts}) < 2 or len(pts) < 3:
        raise ValueError("need >= 3 unsaturated points at >= 2 distinct n")
    z = np.asarray([_norm_ppf_np(f) for _, _, f in pts])
    rhs = np.asarray([math.sqrt(n) * e for n, e, _ in pts])
    a = np.stack([z,
                  np.asarray([-n ** (-1.0 / 6.0) for n, _, _ in pts]),
                  np.asarray([math.sqrt(n) for n, _, _ in pts])], axis=1)
    sol, *_ = np.linalg.lstsq(a, rhs, rcond=None)
    return float(sol[0]), float(sol[1]), float(sol[2])


def fit_waterfall_alpha(points, threshold: float, fit_shift: bool = True):
    """Fit the finite-length scaling law to measured waterfall FERs.

    ``points`` is an iterable of (n, eps, fer) with fer in (0, 1); the
    law P_block = Phi(-sqrt(n)(eps* - eps - beta n^(-2/3)) / alpha) is
    linear in (alpha, beta) after the probit transform:

        -sqrt(n)(eps* - eps) = alpha * z - beta * n^(-1/6),
        z = Phi^{-1}(fer)

    so the fit is a plain least-squares solve (residuals in
    sqrt(n)-erasure units, the axis the law collapses).  Returns
    ``(alpha, beta)``; ``fit_shift=False`` pins beta = 0.  The regular
    (3,6) law (alpha ~= 0.5595, beta ~= 0.6166,
    finite_length_scaling_calculation.py:18-21, :40) is recovered
    exactly from synthetic data (tests/test_theory.py); for irregular
    ensembles this is the measurement route to alpha(lambda, rho) --
    SURVEY's C10 role for (lambda, rho).
    """
    pts = [(float(n), float(e), float(f)) for n, e, f in points
           if 0.0 < f < 1.0]
    if len(pts) < (2 if fit_shift else 1):
        raise ValueError("need at least two unsaturated (n, eps, fer) "
                         "points to fit")
    z = np.asarray([_norm_ppf_np(f) for _, _, f in pts])
    rhs = np.asarray([-math.sqrt(n) * (threshold - e) for n, e, _ in pts])
    cols = [z]
    if fit_shift:
        cols.append(np.asarray([-n ** (-1.0 / 6.0) for n, _, _ in pts]))
    a = np.stack(cols, axis=1)
    sol, *_ = np.linalg.lstsq(a, rhs, rcond=None)
    alpha = float(sol[0])
    beta = float(sol[1]) if fit_shift else 0.0
    return alpha, beta


def _norm_ppf_np(q: float) -> float:
    from .stats import _norm_ppf

    return _norm_ppf(q)


def waterfall_block_error_fitted(n, erasure_probs, threshold: float,
                                 alpha: float, beta: float = 0.0
                                 ) -> np.ndarray:
    """Scaling-law waterfall with explicit (threshold, alpha, beta) --
    the overlay curve for ensembles whose alpha comes from
    :func:`fit_waterfall_alpha` rather than the regular closed form."""
    erasure_probs = np.asarray(erasure_probs, float)
    z = math.sqrt(n) * (threshold - erasure_probs
                        - beta * float(n) ** (-2.0 / 3.0))
    return _norm_cdf(-z / alpha)


def gallager_a_density_evolution(crossover_prob: float, iterations: int,
                                 dv: int, dc: int) -> List[float]:
    """Message-error-probability recursion for Gallager-A on the BSC.

    With x_t the message error rate, a check output is wrong w.p.
    u = (1-(1-2x)^(dc-1))/2 and the Gallager-A variable rule flips the
    channel bit only when all dv-1 other checks agree on the complement:
    x_{t+1} = p0 (1-(1-u)^(dv-1)) + (1-p0) u^(dv-1).

    Analysis-side counterpart of ops/gallager.py (the reference has no BSC
    analysis; this extends tools/density_evolution.py's role to BASELINE
    config 2).
    """
    p0 = crossover_prob
    x = p0
    out = [x]
    for _ in range(iterations):
        u = 0.5 * (1.0 - (1.0 - 2.0 * x) ** (dc - 1))
        x = p0 * (1.0 - (1.0 - u) ** (dv - 1)) + (1.0 - p0) * u ** (dv - 1)
        out.append(x)
    return out


@lru_cache(maxsize=None)
def gallager_a_threshold(dv: int, dc: int, precision: float = 1e-7) -> float:
    """BSC crossover threshold of Gallager-A decoding by bisection.

    Anchor: p*(3,6) ~= 0.0394 (Richardson/Urbanke value for Gallager
    algorithm A on the (3,6) ensemble).
    """
    def dies_out(p0: float) -> bool:
        x = p0
        for _ in range(20_000):
            u = 0.5 * (1.0 - (1.0 - 2.0 * x) ** (dc - 1))
            new_x = (p0 * (1.0 - (1.0 - u) ** (dv - 1))
                     + (1.0 - p0) * u ** (dv - 1))
            if new_x < 1e-12:
                return True
            if abs(new_x - x) < 1e-15:
                return False
            x = new_x
        return x < 1e-12

    lo, hi = 0.0, 0.5
    while hi - lo > precision:
        mid = 0.5 * (lo + hi)
        if dies_out(mid):
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def check_degree_fraction(erasure_prob: float, dv: int, dc: int, degree: int,
                          y) -> np.ndarray:
    """Expected fraction of residual checks with the given degree at
    peeling time y: C(dc,d) (eps y^(dv-1))^d (1 - eps y^(dv-1))^(dc-1)
    (test_peeling_decoder_path.py:18-20)."""
    y = np.asarray(y, float)
    x = erasure_prob * y ** (dv - 1)
    return math.comb(dc, degree) * x ** degree * (1.0 - x) ** (dc - 1)


def calculate_crit_point(erasure_prob: float, dv: int, dc: int,
                         tol: float = 1e-8) -> float:
    """Fixed point x where the peeling drift is tangent to zero
    (test_critical_point_calculator.py:4-11)."""
    prev, x = 0.0, 1.0
    while abs(x - prev) > tol:
        prev = x
        u = 1.0 - erasure_prob * x ** (dv - 1)
        x = (1.0 / dv) * ((dv - 1) - (dv - 1) * u ** (dc - 1)
                          + erasure_prob * (dv - 1) * (dc - 1)
                          * x ** (dv - 1) * u ** (dc - 2))
    return x


def calculate_crit_epsilon(dv: int, dc: int, low: float = 0.2,
                           high: float = 1.0, tol: float = 1e-8) -> float:
    """Bisection for the eps where the tangency point first appears
    (test_critical_point_calculator.py:13-23; note the reference hardwires
    (3,6) inside its loop -- fixed here to use the passed degrees)."""
    while high - low > tol:
        mid = 0.5 * (high + low)
        if abs(calculate_crit_point(mid, dv, dc)) < 1e-9:
            low = mid
        else:
            high = mid
    return high


# ---------------------------------------------------------------------------
# Residual-graph check-degree distribution (test_peeling_decoder_path.py:96-116)
# ---------------------------------------------------------------------------

def _degree_transition_generator(dc: int) -> np.ndarray:
    """Generator A with A[i,i] = -(i+1), A[i,i+1] = i+1 (rows = degree-1
    .. degree-dc), the dc=6 matrix hardcoded at
    test_peeling_decoder_path.py:99 generalised to any dc."""
    a = np.zeros((dc, dc))
    for i in range(dc):
        a[i, i] = -(i + 1)
        if i + 1 < dc:
            a[i, i + 1] = i + 1
    return a


def _expm(a: np.ndarray) -> np.ndarray:
    from scipy.linalg import expm

    return expm(a)


def initial_degree_distribution(erasure_prob: float, dc: int = 6
                                ) -> np.ndarray:
    """Check-degree distribution of the residual graph after stripping the
    received bits: expm(-A ln eps) X0 with X0 = e_dc
    (test_peeling_decoder_path.py:96-100)."""
    a = _degree_transition_generator(dc)
    x0 = np.zeros(dc)
    x0[-1] = 1.0
    return _expm(-a * math.log(erasure_prob)) @ x0


def degree_distribution_at_time(erasure_prob: float, time: float, dv: int = 3,
                                dc: int = 6) -> np.ndarray:
    """Degree-distribution evolution during peeling at normalized time t:
    expm(-C ln((1-t)/eps)) X_init with C = (1/dv) B + ((dv-1)/dv) A
    (test_peeling_decoder_path.py:102-106)."""
    a = _degree_transition_generator(dc)
    b = np.zeros((dc, dc))
    b[0, :] = -1.0
    c = (1.0 / dv) * b + ((dv - 1) / dv) * a
    init = initial_degree_distribution(erasure_prob, dc)
    return _expm(-c * math.log((1.0 - time) / erasure_prob)) @ init


# ---------------------------------------------------------------------------
# Irregular ensembles (capability extension -- the reference is regular-only;
# same DE machinery generalised to edge-perspective degree distributions
# lambda(x), rho(x), after Luby et al. / Richardson-Urbanke)
# ---------------------------------------------------------------------------

def _poly_check(coeffs, name: str) -> np.ndarray:
    c = np.asarray(coeffs, float)
    if c.ndim != 1 or c.size < 2 or c[0] != 0.0:
        raise ValueError(
            f"{name} must be 1-D polynomial coefficients [c0, c1, ...] with "
            "c0 == 0 (no degree-1 edge mass) and degree >= 1")
    if (c < 0).any() or not math.isclose(float(c.sum()), 1.0, abs_tol=1e-9):
        raise ValueError(f"{name} coefficients must be >= 0 and sum to 1")
    return c


def _poly_val(c: np.ndarray, x: float) -> float:
    return float(np.polyval(c[::-1], x))


def design_rate(lam, rho) -> float:
    """1 - (int rho)/(int lambda): the design rate of the (lambda, rho)
    ensemble.  Coefficient convention: ``lam[i]`` multiplies x**i, i.e.
    lam[i] is the fraction of edges attached to degree-(i+1) variables."""
    lam = _poly_check(lam, "lam")
    rho = _poly_check(rho, "rho")
    ints = lambda c: float(sum(ci / (i + 1) for i, ci in enumerate(c)))
    return 1.0 - ints(rho) / ints(lam)


def regular_lam_rho(dv: int, dc: int):
    """The degenerate (lambda, rho) of the (dv,dc)-regular ensemble."""
    lam = np.zeros(dv)
    lam[dv - 1] = 1.0
    rho = np.zeros(dc)
    rho[dc - 1] = 1.0
    return lam, rho


def irregular_density_evolution(erasure_prob: float, lam, rho,
                                iterations: int, threshold: float = 0.0
                                ) -> List[float]:
    """Edge-erasure DE x_{t+1} = eps * lambda(1 - rho(1 - x_t)).

    The irregular generalisation of :func:`density_evolution`; with the
    degenerate distributions of :func:`regular_lam_rho` the two recursions
    are identical.
    """
    lam = _poly_check(lam, "lam")
    rho = _poly_check(rho, "rho")
    results = [erasure_prob]
    x = erasure_prob
    for _ in range(iterations):
        x = erasure_prob * _poly_val(lam, 1.0 - _poly_val(rho, 1.0 - x))
        if x <= threshold:
            break
        results.append(x)
    return results


def irregular_below_threshold(erasure_prob: float, lam, rho,
                              max_iterations: int = 100_000,
                              tolerance: float = 1e-6) -> bool:
    """Does irregular DE drive the edge erasure rate below ``tolerance``?"""
    lam = _poly_check(lam, "lam")
    rho = _poly_check(rho, "rho")
    x = erasure_prob
    for _ in range(max_iterations):
        new_x = erasure_prob * _poly_val(lam, 1.0 - _poly_val(rho, 1.0 - x))
        if new_x < tolerance:
            return True
        # monotone decreasing recursion: stagnation => stuck above tolerance
        if x - new_x < 1e-15:
            return False
        x = new_x
    return x < tolerance


def irregular_threshold(lam, rho, precision: float = 1e-9) -> float:
    """BP threshold eps*(lambda, rho) by the same bisection as
    :func:`calc_threshold`.  Sanity properties (tested): equals the regular
    threshold on degenerate distributions, never exceeds the Shannon limit
    1 - design_rate, and never exceeds the stability limit
    1/(lambda'(0) rho'(1))."""
    lam = _poly_check(lam, "lam")
    rho = _poly_check(rho, "rho")
    lo, hi = 0.0, 1.0
    while hi - lo > precision:
        mid = 0.5 * (lo + hi)
        if irregular_below_threshold(mid, lam, rho):
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def stability_limit(lam, rho) -> float:
    """The stability condition's threshold bound 1/(lambda'(0) rho'(1)):
    eps* <= this for every (lambda, rho) (equality when the degree-2
    variable mass is what limits convergence near the fixed point x=0)."""
    lam = _poly_check(lam, "lam")
    rho = _poly_check(rho, "rho")
    lam2 = float(lam[1])              # lambda'(0)
    rho_d1 = float(sum(i * ci for i, ci in enumerate(rho)))  # rho'(1)
    if lam2 == 0.0:
        return math.inf
    return 1.0 / (lam2 * rho_d1)


# ---------------------------------------------------------------------------
# Gallager-B density evolution on the BSC (analysis-side counterpart of
# ops/gallager.py's threshold parameter; extends the C13 role of
# tools/density_evolution.py to the hard-decision BSC family, like
# gallager_a_density_evolution does for algorithm A.  B with b = dv-1 IS
# algorithm A.)
# ---------------------------------------------------------------------------

def _gallager_b_step(p0: float, x: float, dv: int, dc: int, b: int) -> float:
    """One Gallager-B message-error recursion step with flip threshold b.

    Decoder rule (ops/gallager.py:119-125): the outgoing message flips the
    channel bit iff >= b of the other dv-1 incoming check messages
    disagree with it.  With u the incoming check-message error rate:

      x' = (1-p0) P[>= b of dv-1 wrong] + p0 P[< b of dv-1 right]
    """
    u = 0.5 * (1.0 - (1.0 - 2.0 * x) ** (dc - 1))
    flip_good = sum(math.comb(dv - 1, j) * u ** j * (1 - u) ** (dv - 1 - j)
                    for j in range(b, dv))
    stay_bad = sum(math.comb(dv - 1, j) * (1 - u) ** j * u ** (dv - 1 - j)
                   for j in range(0, b))
    return (1.0 - p0) * flip_good + p0 * stay_bad


def gallager_b_optimal_b(p0: float, x: float, dv: int, dc: int) -> int:
    """The optimal flip threshold at message error rate x: the b in
    [1, dv-1] minimising the next-iteration error (equivalently Gallager's
    smallest-b switching rule, Gallager 1963 eq. 4.16 -- brute force over
    the <= dv-1 candidates is exact and degree-generic).  Ties (e.g. the
    degenerate x == 0 state, where every b maps to 0) break toward the
    LARGEST b -- the most conservative flip rule."""
    return min(range(1, dv),
               key=lambda b: (_gallager_b_step(p0, x, dv, dc, b), -b))


def gallager_b_density_evolution(crossover_prob: float, iterations: int,
                                 dv: int, dc: int, b: int | None = None
                                 ) -> List[float]:
    """Message-error trajectory of Gallager-B on the BSC.

    ``b`` is the fixed flip threshold (ops/gallager.py semantics); ``None``
    applies the optimal switching rule each iteration.  ``b = dv-1``
    reproduces :func:`gallager_a_density_evolution` exactly.
    """
    p0 = crossover_prob
    x = p0
    out = [x]
    for _ in range(iterations):
        bt = gallager_b_optimal_b(p0, x, dv, dc) if b is None else b
        x = _gallager_b_step(p0, x, dv, dc, bt)
        out.append(x)
    return out


@lru_cache(maxsize=None)
def gallager_b_threshold(dv: int, dc: int, b: int | None = None,
                         precision: float = 1e-7) -> float:
    """BSC crossover threshold of Gallager-B decoding by bisection.

    ``b = None`` -> optimal switching rule (the largest achievable
    threshold over flip rules); any fixed b gives that variant's
    threshold.  ``gallager_b_threshold(dv, dc, dv-1)`` equals
    :func:`gallager_a_threshold`.
    """
    def dies_out(p0: float) -> bool:
        x = p0
        for _ in range(20_000):
            bt = gallager_b_optimal_b(p0, x, dv, dc) if b is None else b
            new_x = _gallager_b_step(p0, x, dv, dc, bt)
            if new_x < 1e-12:
                return True
            if abs(new_x - x) < 1e-15:
                return False
            x = new_x
        return x < 1e-12

    lo, hi = 0.0, 0.5
    while hi - lo > precision:
        mid = 0.5 * (lo + hi)
        if dies_out(mid):
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


# ---------------------------------------------------------------------------
# AWGN density evolution (the acceptance oracle for BASELINE config 3 --
# the C13 role of tools/density_evolution.py:9-28 extended to the
# sum-product/AWGN family).  Two independent methods:
#   * Gaussian-approximation DE (Chung, Richardson & Urbanke 2001):
#     one-dimensional recursion on the check-message mean; deterministic,
#     fast, ~0.5% pessimistic on sigma* (GA 0.8747 < exact 0.8790 for
#     (3,6)).
#   * population-dynamics (sampled) DE: exact in the population-size
#     limit; the cross-check that recovers sigma*(3,6) ~= 0.879.
# ---------------------------------------------------------------------------

def _phi_ga(x: float) -> float:
    """phi(x) = 1 - E[tanh(u/2)], u ~ N(x, 2x) -- CRU's standard
    two-piece approximation (continuous at the x=10 seam to ~1e-4)."""
    if x <= 0.0:
        return 1.0
    if x < 10.0:
        return math.exp(-0.4527 * x ** 0.86 + 0.0218)
    return math.sqrt(math.pi / x) * math.exp(-x / 4.0) * (1.0 - 10.0 / (7.0 * x))


def _phi_ga_inv(y: float) -> float:
    """Inverse of the monotone-decreasing :func:`_phi_ga` by bisection."""
    if y >= 1.0:
        return 0.0
    lo, hi = 0.0, 1.0
    while _phi_ga(hi) > y:
        hi *= 2.0
        if hi > 1e9:
            return hi
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if _phi_ga(mid) > y:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def awgn_gaussian_de(sigma: float, iterations: int, dv: int, dc: int
                     ) -> List[float]:
    """Gaussian-approximation DE for sum-product on the BiAWGN channel.

    Tracks the bit error probability Q(sqrt(m_post/2)) of the posterior
    LLR (mean m_post = m0 + dv*m_c, variance 2*m_post under the
    consistent-Gaussian assumption), starting from the channel LLR mean
    m0 = 2/sigma^2.  Returns [P_e^(0), P_e^(1), ...], the overlay curve
    for BER-vs-iteration plots (config 3's analogue of
    modified_density_evolution).
    """
    m0 = 2.0 / (sigma * sigma)
    q = lambda m: 0.5 * math.erfc(math.sqrt(m / 2.0) / math.sqrt(2.0)) \
        if m > 0 else 0.5
    out = [q(m0)]
    mc = 0.0
    for _ in range(iterations):
        mv = m0 + (dv - 1) * mc
        inner = 1.0 - (1.0 - _phi_ga(mv)) ** (dc - 1)
        mc = _phi_ga_inv(inner)
        out.append(q(m0 + dv * mc))
    return out


@lru_cache(maxsize=None)
def awgn_threshold_sigma_ga(dv: int, dc: int, precision: float = 1e-5
                            ) -> float:
    """BiAWGN sum-product threshold sigma* by Gaussian-approximation DE.

    Computed anchor for (3,6): ~0.873-0.875 (the GA is ~0.5% pessimistic
    vs the exact DE value 0.8790 -- both ~= 0.88; see
    :func:`awgn_threshold_sigma_population` for the sampled exact check).
    Decoding succeeds iff the check mean grows without bound.
    """
    def converges(sigma: float) -> bool:
        m0 = 2.0 / (sigma * sigma)
        mc = 0.0
        for _ in range(5000):
            mv = m0 + (dv - 1) * mc
            new_mc = _phi_ga_inv(1.0 - (1.0 - _phi_ga(mv)) ** (dc - 1))
            # mc > 500 <=> message error < Q(sqrt(250)) ~ 1e-56: decoded.
            # (beyond ~1e3 the phi values underflow and the inverse
            # saturates, so the success test must come before the stall
            # test)
            if new_mc > 500.0:
                return True
            if new_mc - mc < 1e-9:
                return False
            mc = new_mc
        return False

    lo, hi = 0.5, 1.5
    if not converges(lo):
        raise ValueError(
            f"threshold below the bisection bracket (sigma={lo} already "
            "fails to converge); widen the bracket for this ensemble")
    while hi - lo > precision:
        mid = 0.5 * (lo + hi)
        if converges(mid):
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def awgn_population_de(sigma: float, iterations: int, dv: int, dc: int,
                       population: int = 1 << 20, seed: int = 0,
                       tol: float = 1e-5) -> List[float]:
    """Sampled (population-dynamics) density evolution for sum-product on
    the BiAWGN channel -- exact as ``population`` -> infinity.

    Maintains a population of variable->check message LLRs (all-zero/BPSK
    +1 transmit convention: channel LLR ~ N(2/sigma^2, 4/sigma^2)); each
    iteration resamples dc-1 inputs per check output and dv-1 check
    outputs per variable output.  Returns the message error probability
    trajectory [P_e^(0), ...]; stops early below ``tol``.
    """
    rng = np.random.default_rng(seed)
    m0, s0 = 2.0 / sigma ** 2, 2.0 / sigma
    msgs = rng.normal(m0, s0, population)
    out = [float((msgs < 0).mean() + 0.5 * (msgs == 0).mean())]
    clip = 0.999999999999
    for _ in range(iterations):
        # check update: 2 atanh(prod_{i<dc-1} tanh(m_i / 2))
        prod = np.ones(population)
        for _i in range(dc - 1):
            prod *= np.tanh(msgs[rng.integers(0, population, population)]
                            / 2.0)
        chk = 2.0 * np.arctanh(np.clip(prod, -clip, clip))
        # variable update: channel + sum of dv-1 fresh check messages
        msgs = rng.normal(m0, s0, population)
        for _i in range(dv - 1):
            msgs = msgs + chk[rng.integers(0, population, population)]
        pe = float((msgs < 0).mean() + 0.5 * (msgs == 0).mean())
        out.append(pe)
        if pe < tol:
            break
    return out


def awgn_threshold_sigma_population(dv: int, dc: int,
                                    precision: float = 2e-3,
                                    population: int = 1 << 20,
                                    iterations: int = 600,
                                    seed: int = 0) -> float:
    """BiAWGN sum-product threshold by bisection over population DE.

    Statistical precision ~ max(precision, O(1/sqrt(population))); with
    the defaults this recovers sigma*(3,6) = 0.879 +- ~0.003 (the exact
    DE value) -- the computed anchor VALIDATION.md checks config 3
    against.
    """
    def converges(sigma: float) -> bool:
        pe = awgn_population_de(sigma, iterations, dv, dc,
                                population=population, seed=seed)
        return pe[-1] < 1e-5

    lo, hi = 0.6, 1.2
    if not converges(lo):
        raise ValueError(
            f"threshold below the bisection bracket (sigma={lo} already "
            "fails to converge); widen the bracket for this ensemble")
    while hi - lo > precision:
        mid = 0.5 * (lo + hi)
        if converges(mid):
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def node_perspective(lam) -> np.ndarray:
    """Edge-perspective lam -> node-perspective Lambda coefficients
    (Lambda[i] = fraction of *nodes* with degree i+1)."""
    lam = _poly_check(lam, "lam")
    degs = np.arange(1, lam.size + 1)
    node = np.where(lam > 0, lam / degs, 0.0)
    return node / node.sum()


def irregular_modified_density_evolution(erasure_prob: float, lam, rho,
                                         iterations: int,
                                         threshold: float = 0.0
                                         ) -> List[float]:
    """Bit-erasure DE for the (lambda, rho) ensemble: alongside the edge
    recursion x' = eps lambda(1 - rho(1-x)), the *bit* erasure
    probability after each round is eps Lambda(1 - rho(1-x)) with Lambda
    the node-perspective variable distribution -- the irregular
    generalisation of :func:`modified_density_evolution`
    (tools/density_evolution.py:18-28), the overlay curve for
    BER-vs-iteration plots of irregular simulations."""
    lam = _poly_check(lam, "lam")
    rho = _poly_check(rho, "rho")
    node = node_perspective(lam)
    # Lambda(y) = sum_d node_d y^d  (node_d indexed from degree 1)
    lam_node_val = lambda y: float(
        sum(nd * y ** (i + 1) for i, nd in enumerate(node)))
    results = [erasure_prob]
    x = erasure_prob
    for _ in range(iterations):
        inner = 1.0 - _poly_val(rho, 1.0 - x)
        bit_prob = erasure_prob * lam_node_val(inner)
        x = erasure_prob * _poly_val(lam, inner)
        if bit_prob <= threshold:
            break
        results.append(bit_prob)
    return results


# ---------------------------------------------------------------------------
# Irregular ensemble DESIGN: optimal lambda by linear programming.
#
# For fixed rho and erasure probability eps, the BEC DE success condition
# eps * lambda(1 - rho(1-x)) < x for all x in (0, eps] is LINEAR in the
# lambda coefficients (Luby et al. / Shokrollahi's classic observation),
# so "the best variable-degree distribution" is a HOST-SIDE LP -- design
# happens in milliseconds, then the sampled ensemble runs through the
# same device Monte Carlo pipeline as any other (lam, rho).
# ---------------------------------------------------------------------------

def optimize_lambda(rho, dv_max: int, epsilon: float,
                    grid_points: int = 200):
    """Max-rate lambda for fixed rho at erasure probability eps.

    Maximises int(lambda) = sum lam_d / d  (equivalently the design rate
    1 - int(rho)/int(lambda)) subject to

      * lam >= 0, no degree-1 mass, sum lam = 1, degrees <= dv_max;
      * eps * lambda(1 - rho(1-x)) <= x on a grid over (0, eps]
        (the DE success condition, linear in lam);
      * the exact stability condition eps * lambda'(0) * rho'(1) <= 1.

    Returns (lam, achieved_rate) or (None, None) if infeasible.
    """
    from scipy.optimize import linprog

    rho = _poly_check(rho, "rho")
    ndeg = dv_max - 1                       # variables: lam_2 .. lam_dv_max
    # objective: maximise sum lam_d / d  ->  minimise -c x
    c = -np.asarray([1.0 / d for d in range(2, dv_max + 1)])
    # DE constraints on a grid biased toward 0 (where the fight happens)
    xs = epsilon * (np.linspace(0.0, 1.0, grid_points + 1)[1:] ** 2)
    a_ub, b_ub = [], []
    for x in xs:
        y = 1.0 - _poly_val(rho, 1.0 - x)
        a_ub.append([epsilon * y ** (d - 1) for d in range(2, dv_max + 1)])
        b_ub.append(x)
    # stability: eps * lam_2 * rho'(1) <= 1
    rho_d1 = float(sum(i * ci for i, ci in enumerate(rho)))
    row = [0.0] * ndeg
    row[0] = epsilon * rho_d1
    a_ub.append(row)
    b_ub.append(1.0)
    a_eq = [[1.0] * ndeg]
    b_eq = [1.0]
    res = linprog(c, A_ub=np.asarray(a_ub), b_ub=np.asarray(b_ub),
                  A_eq=np.asarray(a_eq), b_eq=b_eq,
                  bounds=[(0.0, 1.0)] * ndeg, method="highs")
    if not res.success:
        return None, None
    lam = np.zeros(dv_max)
    lam[1:] = np.maximum(res.x, 0.0)
    lam /= lam.sum()
    ints = lambda cs: float(sum(ci / (i + 1) for i, ci in enumerate(cs)))
    rate = 1.0 - ints(rho) / ints(lam)
    return lam, rate


def optimize_lambda_for_rate(rho, dv_max: int, target_rate: float,
                             precision: float = 1e-4,
                             grid_points: int = 200):
    """The largest eps whose max-rate lambda still achieves target_rate:
    bisection over :func:`optimize_lambda`.  Returns (lam, eps).

    The classic design loop for BEC LDPC ensembles; with dv_max -> inf
    the achievable eps approaches the Shannon limit 1 - target_rate
    (capacity-achieving sequences).  The returned threshold is grid-
    approximate -- re-verify with :func:`irregular_threshold`.
    """
    lo, hi = 0.0, 1.0 - target_rate    # Shannon bound
    best = None
    while hi - lo > precision:
        mid = 0.5 * (lo + hi)
        lam, rate = optimize_lambda(rho, dv_max, mid, grid_points)
        if lam is not None and rate >= target_rate - 1e-9:
            best, lo = lam, mid
        else:
            hi = mid
    return best, lo


def gallager_b_schedule(crossover_prob: float, iterations: int, dv: int,
                        dc: int) -> List[int]:
    """The optimal per-iteration flip-threshold sequence b_t.

    Runs the optimal-rule DE and records the b chosen at each step --
    feed to ``ops.gallager.gallager_decode_packed(..., schedule=...)`` to
    realise Gallager's optimal switching rule on the device (early
    iterations use a lower threshold while messages are unreliable, then
    switch up as they clean)."""
    p0 = crossover_prob
    x = p0
    out = []
    for _ in range(iterations):
        b = gallager_b_optimal_b(p0, x, dv, dc)
        out.append(b)
        x = _gallager_b_step(p0, x, dv, dc, b)
    return out


def awgn_population_de_minsum(sigma: float, iterations: int, dv: int,
                              dc: int, population: int = 1 << 20,
                              seed: int = 0, tol: float = 1e-5,
                              int8_scale: float | None = None,
                              alpha: float = 1.0, beta: float = 0.0
                              ) -> List[float]:
    """Population-dynamics DE for (unnormalised) MIN-SUM on the BiAWGN
    channel -- the production decoder's own density evolution.

    Check update: sign-product x magnitude-min over dc-1 sampled inputs
    (ops/soft_bp._check_update_minsum algebra), with the decoder's
    optional normalisation (``alpha``) and offset (``beta``) corrections
    applied to the magnitude.  ``int8_scale`` not None
    additionally quantises every message to int8 LSBs at that scale
    (round + saturate at +-127), modelling ``soft_msg_dtype="int8"``.
    Returns the message error trajectory.
    """
    rng = np.random.default_rng(seed)
    m0, s0 = 2.0 / sigma ** 2, 2.0 / sigma

    def q(x):
        if int8_scale is None:
            return x
        return np.clip(np.round(x * int8_scale), -127, 127) / int8_scale

    msgs = q(rng.normal(m0, s0, population))
    out = [float((msgs < 0).mean() + 0.5 * (msgs == 0).mean())]
    for _ in range(iterations):
        mags = None
        sgns = None
        for _i in range(dc - 1):
            x = msgs[rng.integers(0, population, population)]
            a = np.abs(x)
            s = np.sign(x) + (x == 0)  # zero counts as +
            mags = a if mags is None else np.minimum(mags, a)
            sgns = s if sgns is None else sgns * s
        if beta:
            mags = np.maximum(mags - beta, 0.0)
        if alpha != 1.0:
            mags = alpha * mags
        chk = q(sgns * mags)
        msgs = q(rng.normal(m0, s0, population))
        for _i in range(dv - 1):
            msgs = q(msgs + chk[rng.integers(0, population, population)])
        pe = float((msgs < 0).mean() + 0.5 * (msgs == 0).mean())
        out.append(pe)
        if pe < tol:
            break
    return out


def awgn_threshold_sigma_minsum(dv: int, dc: int,
                                precision: float = 2e-3,
                                population: int = 1 << 20,
                                iterations: int = 400, seed: int = 0,
                                int8_scale: float | None = None,
                                alpha: float = 1.0,
                                beta: float = 0.0) -> float:
    """BiAWGN min-sum threshold by bisection over the sampled DE.

    The computed anchor for the measured min-sum / int8-min-sum
    waterfalls (docs/VALIDATION.md config 3): unnormalised min-sum pays
    the textbook fraction-of-a-dB penalty vs sum-product, and int8
    quantisation at the default scale costs almost nothing more.
    """
    def converges(sigma: float) -> bool:
        pe = awgn_population_de_minsum(sigma, iterations, dv, dc,
                                       population=population, seed=seed,
                                       int8_scale=int8_scale,
                                       alpha=alpha, beta=beta)
        return pe[-1] < 1e-5

    lo, hi = 0.5, 1.2
    if not converges(lo):
        raise ValueError(
            f"threshold below the bisection bracket (sigma={lo} already "
            "fails); widen the bracket for this ensemble")
    while hi - lo > precision:
        mid = 0.5 * (lo + hi)
        if converges(mid):
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def irregular_gallager_b_density_evolution(crossover_prob: float, lam, rho,
                                           iterations: int,
                                           b: int | None = None
                                           ) -> List[float]:
    """Gallager-B message-error DE for an irregular (lambda, rho)
    ensemble on the BSC, with one flip threshold ``b`` shared across
    degrees (clamped per degree to its d-1 extrinsic inputs; ``None`` ->
    each degree uses its Gallager-A rule b = d-1).

    Edge-averaged recursion: the check extrinsic error is
    u = (1 - rho(1-2x))/2 and the variable side averages the regular
    per-degree step over the edge-degree distribution lambda.
    """
    lam = _poly_check(lam, "lam")
    rho = _poly_check(rho, "rho")
    p0 = crossover_prob
    x = p0
    out = [x]
    for _ in range(iterations):
        x = _irregular_gallager_b_step(p0, x, lam, rho, b)
        out.append(x)
    return out


def _irregular_gallager_b_step(p0: float, x: float, lam, rho,
                               b: int | None) -> float:
    """One edge-averaged irregular Gallager-B step (lam/rho pre-checked;
    _poly_check guarantees no degree-1 edge mass, so every active degree
    has >= 1 extrinsic input)."""
    u = 0.5 * (1.0 - _poly_val(rho, 1.0 - 2.0 * x))
    new_x = 0.0
    for i, li in enumerate(lam):
        if li == 0.0:
            continue
        others = i  # degree i+1 variable: i extrinsic inputs
        bt = others if b is None else min(b, others)
        flip_good = sum(
            math.comb(others, j) * u ** j * (1 - u) ** (others - j)
            for j in range(bt, others + 1))
        stay_bad = sum(
            math.comb(others, j) * (1 - u) ** j * u ** (others - j)
            for j in range(0, bt))
        new_x += li * ((1.0 - p0) * flip_good + p0 * stay_bad)
    return new_x


def irregular_gallager_b_threshold(lam, rho, b: int | None = None,
                                   precision: float = 1e-6) -> float:
    """BSC crossover threshold of Gallager-B on the (lambda, rho)
    ensemble by bisection (degenerate distributions reproduce
    :func:`gallager_b_threshold` / :func:`gallager_a_threshold`)."""
    lam_c = _poly_check(lam, "lam")
    rho_c = _poly_check(rho, "rho")

    def dies_out(p0: float) -> bool:
        x = p0
        for _ in range(20_000):
            new_x = _irregular_gallager_b_step(p0, x, lam_c, rho_c, b)
            if new_x < 1e-12:
                return True
            if abs(new_x - x) < 1e-15:
                return False
            x = new_x
        return x < 1e-12

    lo, hi = 0.0, 0.5
    while hi - lo > precision:
        mid = 0.5 * (lo + hi)
        if dies_out(mid):
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def irregular_awgn_gaussian_de(sigma: float, lam, rho, iterations: int
                               ) -> List[float]:
    """Gaussian-approximation DE for sum-product on the BiAWGN channel,
    irregular (lambda, rho) ensemble (Chung-Richardson-Urbanke's
    irregular recursion with edge-mixture phi averages).

    Tracks s = E_lambda[phi(m_v)]; check means mix over rho through
    phi^{-1}(1 - (1 - s)^j).  Returns the approximate bit error
    trajectory Q(sqrt(m_post/2)) with m_post averaged node-perspective.
    """
    lam = _poly_check(lam, "lam")
    rho = _poly_check(rho, "rho")
    node = node_perspective(lam)
    m0 = 2.0 / (sigma * sigma)
    q = lambda m: 0.5 * math.erfc(math.sqrt(m / 2.0) / math.sqrt(2.0)) \
        if m > 0 else 0.5
    mu_c = 0.0
    out = [q(m0)]
    for _ in range(iterations):
        s = sum(li * _phi_ga(m0 + i * mu_c)
                for i, li in enumerate(lam) if li > 0)
        mu_c = sum(rj * _phi_ga_inv(1.0 - (1.0 - s) ** j)
                   for j, rj in enumerate(rho) if rj > 0)
        m_post = sum(nd * (m0 + (i + 1) * mu_c)
                     for i, nd in enumerate(node) if nd > 0)
        out.append(q(m_post))
    return out


def irregular_awgn_threshold_sigma_ga(lam, rho,
                                      precision: float = 1e-4) -> float:
    """BiAWGN sum-product threshold of a (lambda, rho) ensemble by the
    irregular Gaussian-approximation DE (degenerate pairs reproduce
    :func:`awgn_threshold_sigma_ga`) -- the anchor for irregular
    soft-decision Monte Carlo."""
    lam_c = _poly_check(lam, "lam")
    rho_c = _poly_check(rho, "rho")

    def converges(sigma: float) -> bool:
        m0 = 2.0 / (sigma * sigma)
        mu_c = 0.0
        for _ in range(5000):
            s = sum(li * _phi_ga(m0 + i * mu_c)
                    for i, li in enumerate(lam_c) if li > 0)
            new_mu = sum(rj * _phi_ga_inv(1.0 - (1.0 - s) ** j)
                         for j, rj in enumerate(rho_c) if rj > 0)
            # Past the early bottleneck the GA drift is provably positive
            # (the smallest-degree edge gives mu' >= m0 + mu + const), so
            # genuine fixed points only exist at small mu -- but float
            # underflow of s plateaus mu around phi^{-1}(~1e-15) ~ 130
            # with an exactly-zero delta.  Declare success at mu > 50;
            # a stall below that is a real sub-threshold fixed point.
            if new_mu > 50.0:
                return True
            if new_mu - mu_c < 1e-9:
                return False
            mu_c = new_mu
        return False

    lo, hi = 0.5, 1.5
    if not converges(lo):
        raise ValueError(
            f"threshold below the bisection bracket (sigma={lo} already "
            "fails); widen the bracket for this ensemble")
    while hi - lo > precision:
        mid = 0.5 * (lo + hi)
        if converges(mid):
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def optimize_lambda_awgn(rho, dv_max: int, sigma: float,
                         grid_points: int = 200):
    """Max-rate lambda for fixed rho on the BiAWGN channel at noise
    ``sigma`` -- the Gaussian-approximation analogue of
    :func:`optimize_lambda` (Chung-Richardson-Urbanke's LP design): for
    a fixed rho the GA success condition

        sum_i lam_i phi(m0 + (i) mu_c(s)) <= s   for all s in (0, s0]

    with mu_c(s) = sum_j rho_j phi^{-1}(1-(1-s)^j) is LINEAR in the
    lambda coefficients.  Returns (lam, achieved_rate) or (None, None).
    """
    from scipy.optimize import linprog

    rho = _poly_check(rho, "rho")
    m0 = 2.0 / (sigma * sigma)
    s0 = _phi_ga(m0)
    ndeg = dv_max - 1
    c = -np.asarray([1.0 / d for d in range(2, dv_max + 1)])
    # grid biased toward s -> 0 (the convergence bottleneck)
    ss = s0 * (np.linspace(0.0, 1.0, grid_points + 1)[1:] ** 2)
    a_ub, b_ub = [], []
    for s in ss:
        mu = sum(rj * _phi_ga_inv(1.0 - (1.0 - s) ** j)
                 for j, rj in enumerate(rho) if rj > 0)
        a_ub.append([_phi_ga(m0 + (d - 1) * mu)
                     for d in range(2, dv_max + 1)])
        b_ub.append(s)
    # exact BiAWGN stability condition: lambda'(0) rho'(1) < e^{1/(2 s^2)}
    # -- the GA grid alone cannot see it (as s -> 0, mu -> inf and every
    # phi(m0 + (d-1) mu) -> 0, so nothing bounds lambda2), and without it
    # the LP returns ensembles with an unstable x=0 fixed point, i.e. a
    # BER floor the claimed threshold does not predict
    rho_d1 = float(sum(j * rj for j, rj in enumerate(rho)))
    row = [0.0] * ndeg
    row[0] = rho_d1
    a_ub.append(row)
    b_ub.append(math.exp(1.0 / (2.0 * sigma * sigma)))
    a_eq = [[1.0] * ndeg]
    res = linprog(c, A_ub=np.asarray(a_ub), b_ub=np.asarray(b_ub),
                  A_eq=np.asarray(a_eq), b_eq=[1.0],
                  bounds=[(0.0, 1.0)] * ndeg, method="highs")
    if not res.success:
        return None, None
    lam = np.zeros(dv_max)
    lam[1:] = np.maximum(res.x, 0.0)
    lam /= lam.sum()
    ints = lambda cs: float(sum(ci / (i + 1) for i, ci in enumerate(cs)))
    rate = 1.0 - ints(rho) / ints(lam)
    return lam, rate


def optimize_lambda_awgn_for_rate(rho, dv_max: int, target_rate: float,
                                  precision: float = 1e-3,
                                  grid_points: int = 200):
    """Largest sigma whose GA-optimal lambda reaches target_rate
    (bisection over :func:`optimize_lambda_awgn`); returns (lam, sigma).
    Grid/GA-approximate -- re-verify with
    :func:`irregular_awgn_threshold_sigma_ga`."""
    lo, hi = 0.5, 1.5
    best = None
    while hi - lo > precision:
        mid = 0.5 * (lo + hi)
        lam, rate = optimize_lambda_awgn(rho, dv_max, mid, grid_points)
        if lam is not None and rate >= target_rate - 1e-9:
            best, lo = lam, mid
        else:
            hi = mid
    return best, lo


# ---------------------------------------------------------------------------
# Protograph (P-EXIT) density evolution -- the theory behind QC lifts.
#
# Per-EDGE DE on a base graph is exact for the Z -> infinity ensemble of
# random-permutation lifts (the lifted local tree is the base's
# universal cover), and the governing limit for the circulant lifts in
# models/qc.py: round-5 measurements (docs/VALIDATION.md "base-size
# law") show the lifted waterfall follows the BASE graph's threshold,
# not the unstructured (lambda, rho) ensemble's, with the gap closing
# as the base grows.
# ---------------------------------------------------------------------------

def protograph_de(base_chk, nb: int, erasure_prob: float,
                  max_iterations: int = 10_000,
                  tolerance: float = 1e-9):
    """Per-edge BEC density evolution on a base graph.

    ``base_chk`` is an [mb, dcb(_max)] check->variable-block table
    (entries >= nb = padding, skipped -- both QCLDPCCode.base_chk and
    IrregularQCLDPCCode.base_chk work directly).  Returns the vector of
    per-edge variable->check erasure probabilities at the fixed point
    (all ~0 iff decodable).

      x_e = eps * prod_{e' in v(e), e' != e} y_{e'}
      y_e = 1 - prod_{e' in c(e), e' != e} (1 - x_{e'})
    """
    import numpy as np

    base = np.asarray(base_chk)
    edges = [(c, int(base[c, j]))
             for c in range(base.shape[0])
             for j in range(base.shape[1]) if base[c, j] < nb]
    E = len(edges)
    chk_edges = {}
    var_edges = {}
    for e, (c, v) in enumerate(edges):
        chk_edges.setdefault(c, []).append(e)
        var_edges.setdefault(v, []).append(e)
    x = np.full(E, float(erasure_prob))
    for _ in range(max_iterations):
        # check -> variable
        y = np.empty(E)
        for c, es in chk_edges.items():
            prod_all = np.prod([1.0 - x[e] for e in es])
            for e in es:
                rest = prod_all / (1.0 - x[e]) if x[e] < 1.0 else \
                    np.prod([1.0 - x[o] for o in es if o != e])
                y[e] = 1.0 - rest
        # variable -> check
        new_x = np.empty(E)
        for v, es in var_edges.items():
            for e in es:
                others = np.prod([y[o] for o in es if o != e])
                new_x[e] = erasure_prob * others
        if np.max(np.abs(new_x - x)) < tolerance * 1e-3:
            x = new_x
            break
        x = new_x
    return x


def protograph_threshold(base_chk, nb: int, precision: float = 1e-5,
                         tolerance: float = 1e-6) -> float:
    """BP threshold of the Z->infinity lift of a base graph (bisection
    over :func:`protograph_de`).

    A regular base reproduces eps*(dv, dc) exactly (its universal cover
    is the regular tree); small irregular bases come out BELOW the
    unstructured (lambda, rho) ensemble threshold -- the frozen base
    connectivity is a constraint, quantifying round 5's measured
    base-size law.
    """
    lo, hi = 0.0, 1.0
    while hi - lo > precision:
        mid = 0.5 * (lo + hi)
        x = protograph_de(base_chk, nb, mid, max_iterations=5_000,
                          tolerance=tolerance)
        if float(x.max()) < tolerance:
            lo = mid
        else:
            hi = mid
    return lo
