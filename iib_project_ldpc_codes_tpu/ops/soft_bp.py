"""Soft-decision BP for AWGN/BSC LLRs: sum-product, min-sum, int8 min-sum.

Behaviour extension over the reference (BEC-only) per BASELINE.json config 3
("AWGN sum-product BP, n=8192, batched Monte Carlo BER/FER curve").  Same
edge-list gather skeleton as the erasure/Gallager kernels; message algebra
is real-valued LLRs, batch in the trailing (lane) dimension.

The decoder state is *check-resident* and stored as ONE flat array of
check->variable messages, [dc*m, B] in the working dtype (rows j*m..j*m+m
= socket j's plane).  Each round:

  1. variable update: posterior = llr + sum of dv incoming messages
     (dv gathers of flat rows -- the only persistent state read);
  2. the posterior is cast to the working dtype and gathered to the check
     side (dc gathers); the parity-check syndrome falls out of the sign
     bits of those rows, so convergence checking is free;
  3. extrinsic subtraction at the check side (gathered posterior minus own
     incoming message, read as a *contiguous slice* of the flat state) and
     the check update, written back as one concatenate.

The flat carry has no per-round stack/reshape copy: slices of the flat
array are free.  The message dtype sets the bytes each round's gathers
move (f32 > bf16 > int8).

Working dtypes (``msg_dtype``):
  * float32 -- exact reference arithmetic;
  * bfloat16 -- halves the gather traffic; the posterior and check-update
    arithmetic stay f32 (8 mantissa bits match the 6-8 bit quantisation of
    production min-sum hardware; tiny BER shift near threshold only);
  * int8 (min-sum only) -- production-style quantised decoder: LLRs scaled
    by ``int8_scale`` (default 4 LSB/LLR-unit, saturating at +-127 ~=
    +-31.75 LLR), int16 accumulation.  The saturation acts like an offset
    correction, so its BER at moderate SNR is on par with (measured:
    slightly better than) unnormalised f32 min-sum.

Check update:
  * min-sum: extrinsic |m| and sign via prefix/suffix min / sign-product
    scans (O(dc) instead of the reference's O(dc^2) leave-one-out loop,
    message_passing.c:30-37); optional normalisation (alpha) and offset
    (beta) corrections;
  * sum-product: 2 atanh(prod tanh(m/2)) computed extrinsically with
    prefix/suffix products in tanh space, clipped for stability.

Decision: sign of the posterior LLR; convergence via the parity-check
syndrome (early exit when every check of every trial is satisfied),
replacing the BEC-specific erasure-count rules.
"""

from __future__ import annotations

import dataclasses
from functools import partial
import jax
import jax.numpy as jnp

from ..models.code import LDPCCode

_LLR_CLIP = 30.0
_TANH_CLIP = 0.999999
_INT8_MAX = 127


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SoftBPResult:
    # bool[n, B]: hard decisions (True = bit 1) under the default
    # all-zero transmit; with tx_bits given, decision-vs-transmit ERROR
    # indicators (decisions XOR tx) -- identical objects for all-zero.
    hard: jax.Array
    posterior: jax.Array     # f32[n, B] posterior LLRs (decision-space)
    satisfied: jax.Array     # bool[B] all checks satisfied (decision-space)
    error_totals: jax.Array  # int32[max_iters+1] errors vs the transmit
    iterations: jax.Array
    # int32[max_iters+1, B] per-trial error trajectories (only with
    # record="per_trial"; same per-iteration indexing as error_totals,
    # which then equals traj.sum(axis=1)).  Feeds the exactly-expurgated
    # driver (parallel_simulator_expurgated.py:238 semantics).
    traj: jax.Array | None = None

    @property
    def bit_errors(self) -> jax.Array:
        """int32[B] decision errors per trial (vs the transmit)."""
        return jnp.sum(self.hard, axis=0).astype(jnp.int32)

    @property
    def failed(self) -> jax.Array:
        """bool[B]: any decision error (vs the transmit)."""
        return jnp.any(self.hard, axis=0)


def _check_update_minsum(planes, alpha: float, beta: float, mag_cap=None):
    """dc planes [m, B] -> dc extrinsic planes (f32 or integer math).

    Extrinsic |m| via prefix/suffix mins (no one-hot two-min bookkeeping
    needed in plane form), extrinsic sign via prefix/suffix sign products.
    ``mag_cap`` saturates the output magnitude (int8 quantised path).
    """
    dc = len(planes)
    mags = [jnp.abs(p) for p in planes]
    sgns = [p < 0 for p in planes]
    if mag_cap is None:
        big = jnp.full_like(planes[0], jnp.inf)
    else:
        big = jnp.full_like(planes[0], 4 * mag_cap)
    pre_m, suf_m = [big], [big]
    pre_s = [jnp.zeros_like(sgns[0])]
    suf_s = [jnp.zeros_like(sgns[0])]
    for j in range(dc - 1):
        pre_m.append(jnp.minimum(pre_m[-1], mags[j]))
        pre_s.append(pre_s[-1] ^ sgns[j])
    for j in range(dc - 1, 0, -1):
        suf_m.append(jnp.minimum(suf_m[-1], mags[j]))
        suf_s.append(suf_s[-1] ^ sgns[j])
    suf_m.reverse()
    suf_s.reverse()
    out = []
    for j in range(dc):
        mag = jnp.minimum(pre_m[j], suf_m[j])
        if beta:
            mag = jnp.maximum(mag - beta, 0.0)
        if alpha != 1.0:
            mag = alpha * mag
        if mag_cap is not None:
            mag = jnp.minimum(mag, jnp.asarray(mag_cap, mag.dtype))
        out.append(jnp.where(pre_s[j] ^ suf_s[j], -mag, mag))
    return out


def _check_update_sumproduct(planes):
    dc = len(planes)
    ts = [jnp.clip(jnp.tanh(jnp.clip(p, -_LLR_CLIP, _LLR_CLIP) / 2.0),
                   -_TANH_CLIP, _TANH_CLIP) for p in planes]
    one = jnp.ones_like(ts[0])
    pre, suf = [one], [one]
    for j in range(dc - 1):
        pre.append(pre[-1] * ts[j])
    for j in range(dc - 1, 0, -1):
        suf.append(suf[-1] * ts[j])
    suf.reverse()
    return [2.0 * jnp.arctanh(jnp.clip(pre[j] * suf[j], -_TANH_CLIP,
                                       _TANH_CLIP))
            for j in range(dc)]


def _soft_routing(code: LDPCCode):
    """Static per-socket table: variable socket p -> flat check-plane row.

    ``to_var_idx[p][v]`` indexes the flat [dc*m, B] check state at the
    message feeding socket p of variable v (edge e = c*dc + j maps to
    flat row j*m + c).
    """
    dv, dc, m = code.dv, code.dc, code.m
    to_var_idx = []
    for p in range(dv):
        e = code.var_to_edge[:, p]
        to_var_idx.append((e % dc) * m + e // dc)
    return to_var_idx


def _posterior(code: LDPCCode, llr0, mcv, to_var_idx, acc_dtype):
    """posterior = channel LLR + sum of dv incoming messages (acc dtype)."""
    post = llr0.astype(acc_dtype)
    for p in range(code.dv):
        post = post + jnp.take(mcv, to_var_idx[p], axis=0).astype(acc_dtype)
    return post


def _soft_iteration(code: LDPCCode, llr0, mcv, to_var_idx, method: str,
                    alpha: float, beta: float, acc_dtype, quantised: bool,
                    chk_sock_mask=None):
    """One flooding round over the flat check-resident state.

    Returns (new flat mcv, posterior entering this round, syndrome-ok
    bool[B] of that posterior).  ``llr0`` is the channel LLR in the
    round's input representation (f32, or int8-quantised).

    ``chk_sock_mask`` (irregular codes only): per-socket column masks
    [m, 1] zeroing the state rows of phantom/padded check sockets each
    round, so padded sockets always present a zero stored message -- the
    extrinsic subtraction then sees the phantom variable's pinned-LARGE
    posterior unreduced (exactly a "known 0" input).
    """
    dc, m = code.dc, code.m
    dtype = mcv.dtype

    post = _posterior(code, llr0, mcv, to_var_idx, acc_dtype)

    # route the posterior to the check side in the working dtype; the
    # syndrome falls out of the gathered sign bits
    if quantised:
        pm = jnp.clip(post, -_INT8_MAX, _INT8_MAX).astype(dtype)
    else:
        pm = post.astype(dtype)
    post_rows = [jnp.take(pm, code.chk_to_var[:, j], axis=0)
                 for j in range(dc)]
    parity = post_rows[0] < 0
    for j in range(1, dc):
        parity = parity ^ (post_rows[j] < 0)
    sat = ~jnp.any(parity, axis=0)

    # extrinsic subtraction at the check side: own incoming message is a
    # contiguous slice of the flat state
    rows = [post_rows[j].astype(acc_dtype)
            - mcv[j * m:(j + 1) * m].astype(acc_dtype) for j in range(dc)]
    if quantised:
        new_rows = _check_update_minsum(rows, alpha, beta,
                                        mag_cap=_INT8_MAX)
    else:
        rows = [jnp.clip(r, -_LLR_CLIP, _LLR_CLIP) for r in rows]
        if method == "minsum":
            new_rows = _check_update_minsum(rows, alpha, beta)
        else:
            new_rows = _check_update_sumproduct(rows)
    if chk_sock_mask is not None:
        new_rows = [jnp.where(chk_sock_mask[j], r, 0)
                    for j, r in enumerate(new_rows)]
    new_mcv = jnp.concatenate([r.astype(dtype) for r in new_rows], axis=0)
    return new_mcv, post, sat


def _syndrome_ok(code: LDPCCode, hard: jax.Array) -> jax.Array:
    """bool[B]: every check satisfied (sum of participant bits even)."""
    bits = jnp.take(hard.astype(jnp.int32), code.chk_to_var.reshape(-1),
                    axis=0).reshape(code.m, code.dc, -1)
    parity = jnp.sum(bits, axis=1) % 2
    return ~jnp.any(parity, axis=0)


def _soft_decode(code, llr, max_iters, method, alpha, beta, msg_dtype,
                 int8_scale, to_var_idx, chk_sock_mask=None,
                 tx_bits=None, record="total") -> SoftBPResult:
    """Shared decode loop for the regular and irregular wrappers.

    ``code`` is any view exposing ``dv``/``dc``/``m``/``chk_to_var``;
    ``llr`` may contain phantom rows (pinned-LARGE; they never count as
    errors because their posterior stays positive).

    ``tx_bits`` (bool[n, B], True = transmitted bit 1) switches error
    accounting to the nonzero-codeword convention: ``error_totals`` and
    the returned ``hard`` planes hold decision-vs-transmit ERROR
    indicators (decisions XOR tx), so ``bit_errors``/``failed`` count
    true errors; ``posterior`` and ``satisfied`` stay decision-space.
    ``None`` keeps the reference's all-zero convention
    (parallel_simulator.py:222), where the two coincide.
    """
    llr = jnp.asarray(llr, jnp.float32)
    quantised = jnp.dtype(msg_dtype) == jnp.int8
    if quantised and method != "minsum":
        raise ValueError("int8 messages require method='minsum'")
    if quantised and (alpha != 1.0 or beta != 0.0):
        raise ValueError("int8 min-sum: saturation replaces alpha/beta "
                         "corrections")
    if quantised:
        acc_dtype = jnp.int16
        llr0 = jnp.clip(jnp.round(llr * int8_scale), -_INT8_MAX,
                        _INT8_MAX).astype(jnp.int8)
    else:
        acc_dtype = jnp.float32
        llr0 = llr
    from .bitops import with_vma_of

    # Initial carries must carry the llr's varying-manual-axes type for
    # shard_map's checker (while_loop does not promote; see
    # bitops.with_vma_of) -- the body outputs are llr-derived.
    mcv0 = with_vma_of(jnp.zeros((code.dc * code.m, llr.shape[1]),
                                 msg_dtype), llr0)
    if record not in ("total", "per_trial"):
        raise ValueError(f"unknown record mode {record!r}")
    if tx_bits is None:
        as_err = lambda decisions: decisions
    else:
        tx = jnp.asarray(tx_bits, bool)
        as_err = lambda decisions: decisions ^ tx
    if record == "total":
        counts_of = lambda dec: jnp.sum(as_err(dec)).astype(jnp.int32)
    else:
        counts_of = lambda dec: jnp.sum(as_err(dec),
                                        axis=0).astype(jnp.int32)
    c0 = counts_of(llr < 0)
    errors = jnp.zeros((max_iters + 1,) + c0.shape, jnp.int32).at[0].set(c0)

    def cond(carry):
        _, _, it, all_sat = carry
        return (it < max_iters) & ~all_sat

    def body(carry):
        mcv, errors, it, _ = carry
        mcv, post_prev, sat_prev = _soft_iteration(
            code, llr0, mcv, to_var_idx, method, alpha, beta, acc_dtype,
            quantised, chk_sock_mask)
        # post_prev / sat_prev describe the posterior *entering* this
        # round (after `it` check updates); record its error count.
        errors = errors.at[it].set(counts_of(post_prev < 0))
        return (mcv, errors, it + 1, jnp.all(sat_prev))

    mcv, errors, it, _ = jax.lax.while_loop(
        cond, body,
        (mcv0, errors, jnp.int32(0),
         with_vma_of(jnp.asarray(False), llr0)))

    # reconstruct the final posterior from the check-resident state
    post = _posterior(code, llr0, mcv, to_var_idx, acc_dtype)
    decisions = post < 0
    err = as_err(decisions)
    final = counts_of(decisions)
    tail = jnp.arange(max_iters + 1) >= it
    errors = jnp.where(tail.reshape((-1,) + (1,) * final.ndim), final,
                       errors)
    post_f32 = post.astype(jnp.float32)
    if quantised:
        post_f32 = post_f32 / int8_scale
    if record == "per_trial":
        return SoftBPResult(hard=err, posterior=post_f32,
                            satisfied=_syndrome_ok(code, decisions),
                            error_totals=jnp.sum(errors, axis=1),
                            iterations=it, traj=errors)
    return SoftBPResult(hard=err, posterior=post_f32,
                        satisfied=_syndrome_ok(code, decisions),
                        error_totals=errors, iterations=it)


@partial(jax.jit, static_argnames=("max_iters", "method", "alpha", "beta",
                                   "msg_dtype", "int8_scale", "record"))
def soft_bp_decode(code: LDPCCode, llr: jax.Array, max_iters: int,
                   method: str = "sumproduct", alpha: float = 1.0,
                   beta: float = 0.0, msg_dtype=jnp.float32,
                   int8_scale: float = 4.0,
                   tx_bits: jax.Array | None = None,
                   record: str = "total") -> SoftBPResult:
    """Decode a batch of LLR words; ``llr`` is f32[n, B] channel LLRs
    (positive favours bit 0; ``AWGN.llr`` output).

    Early exit when all trials satisfy every parity check or the iteration
    budget runs out.  ``error_totals`` counts hard-decision errors against
    the all-zero codeword after each round (index 0 = channel decisions).
    The syndrome is read off the sign bits of the posterior rows each
    round already gathers, so checking is free; convergence of the
    round-``t`` posterior is observed at the top of round ``t+1``
    (``iterations`` counts the check-update rounds actually executed --
    at most one more than the round that converged).

    ``msg_dtype`` sets the message precision: float32, bfloat16 (half the
    gather traffic, f32 check-update math), or int8 -- the quantised
    production min-sum (``method`` must be "minsum"; ``int8_scale`` LSBs
    per LLR unit, int16 accumulation, posterior returned de-quantised).

    ``tx_bits`` (bool[n, B]) enables nonzero-codeword error accounting;
    ``record="per_trial"`` fills ``result.traj`` with per-trial error
    trajectories -- see :func:`_soft_decode`.
    """
    return _soft_decode(code, llr, max_iters, method, alpha, beta,
                        msg_dtype, int8_scale, _soft_routing(code),
                        tx_bits=tx_bits, record=record)


# ---------------------------------------------------------------------------
# Irregular codes: phantom-padded reuse of the same kernel.
#
# The phantom variable's channel LLR is pinned LARGE-positive ("known 0"):
# its posterior row is gathered by padded check sockets, where the huge
# magnitude leaves the extrinsic min / tanh-product of the real sockets
# untouched.  Padded-socket state rows are masked to zero each round
# (chk_sock_mask), so (a) the extrinsic subtraction at a padded socket
# sees the full pinned posterior (exact even in int8: 127 - 0), and
# (b) padded variable sockets, routed to the phantom check's zeroed rows,
# gather nothing.
# ---------------------------------------------------------------------------

#: pinned channel LLR of the phantom variable (f32 path; the int8 path
#: saturates it to +127).  Well above _LLR_CLIP so the clipped extrinsic
#: input is exactly the clip ceiling, like any fully-known bit.
_PHANTOM_LLR = 1.0e4


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class _SoftPhantomView:
    """Duck-typed LDPCCode view of an irregular code for _soft_decode."""

    chk_to_var: jax.Array   # int32[m+1, dc_max] (phantom var = n)
    n: int = dataclasses.field(metadata=dict(static=True))   # n + 1
    m: int = dataclasses.field(metadata=dict(static=True))   # m + 1
    dv: int = dataclasses.field(metadata=dict(static=True))  # dv_max
    dc: int = dataclasses.field(metadata=dict(static=True))  # dc_max


def _soft_routing_irregular(code):
    """(view, to_var_idx, chk_sock_mask) for an IrregularLDPCCode.

    Flat state layout [dc_max * (m+1), B]: socket plane j occupies rows
    j*(m+1)..j*(m+1)+m; padded variable sockets route to row m of plane 0
    (a phantom-check row, masked to zero every round).
    """
    m_pad = code.m + 1
    view = _SoftPhantomView(chk_to_var=code.chk_to_var, n=code.n + 1,
                            m=m_pad, dv=code.dv_max, dc=code.dc_max)
    valid = code.var_mask                        # bool[n+1, dv_max]
    to_var_idx = []
    for p in range(code.dv_max):
        sock = code.var_to_sock[:, p]
        c = sock // code.dc_max
        j = sock % code.dc_max
        to_var_idx.append(jnp.where(valid[:, p], j * m_pad + c,
                                    jnp.int32(code.m)))
    chk_sock_mask = [code.chk_mask[:, j:j + 1] for j in range(code.dc_max)]
    return view, to_var_idx, chk_sock_mask


@partial(jax.jit, static_argnames=("max_iters", "method", "alpha", "beta",
                                   "msg_dtype", "int8_scale", "record"))
def soft_bp_decode_irregular(code, llr: jax.Array, max_iters: int,
                             method: str = "sumproduct", alpha: float = 1.0,
                             beta: float = 0.0, msg_dtype=jnp.float32,
                             int8_scale: float = 4.0,
                             tx_bits: jax.Array | None = None,
                             record: str = "total") -> SoftBPResult:
    """:func:`soft_bp_decode` for an :class:`..models.irregular
    .IrregularLDPCCode`; identical semantics, [n, B] outputs."""
    llr = jnp.asarray(llr, jnp.float32)
    view, to_var_idx, chk_sock_mask = _soft_routing_irregular(code)
    llr_pad = jnp.concatenate(
        [llr, jnp.full((1, llr.shape[1]), _PHANTOM_LLR, llr.dtype)], axis=0)
    if tx_bits is not None:
        # phantom row transmits 0 (its pinned-positive posterior never
        # counts as an error either way)
        tx_bits = jnp.concatenate(
            [jnp.asarray(tx_bits, bool),
             jnp.zeros((1, llr.shape[1]), bool)], axis=0)
    res = _soft_decode(view, llr_pad, max_iters, method, alpha, beta,
                       msg_dtype, int8_scale, to_var_idx, chk_sock_mask,
                       tx_bits=tx_bits, record=record)
    # the phantom row never errs (pinned-positive posterior, tx 0), so
    # error_totals/traj need no correction, only the planes are stripped
    return SoftBPResult(hard=res.hard[:-1], posterior=res.posterior[:-1],
                        satisfied=res.satisfied,
                        error_totals=res.error_totals,
                        iterations=res.iterations, traj=res.traj)
