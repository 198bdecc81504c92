"""Gallager-A/B hard-decision decoding for the BSC (bit-packed).

Behaviour extension over the reference (which implements only the BEC --
BASELINE.json config 2: "BSC Gallager-A hard-decision message passing,
n=4096, crossover-prob sweep").  Shares the edge-list gather skeleton of
the erasure decoder (SURVEY.md section 7 design stance: "two
message-passing families ... same edge-list kernel skeleton, different
message algebra").

Messages are single bits, so the packed layout (32 trials/uint32, batch in
lanes) applies directly:

  * check -> variable: extrinsic XOR of the other dc-1 edge bits
    (prefix/suffix XOR scans);
  * variable -> check (Gallager-B with threshold t): send the complement of
    the channel bit iff >= t of the other dv-1 incoming check messages
    disagree with the channel bit; Gallager-A is t = dv-1 (all others
    disagree);
  * decision: majority over {channel bit, all dv incoming messages}.

Disagreement counting across the dv-1 extrinsic inputs is done bit-sliced
(ripple-carry half-adders on uint32 planes), so the whole decoder is
bitwise integer work plus the two static gathers.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import List

import jax
import jax.numpy as jnp

from ..models.code import LDPCCode
from .bitops import per_trial_counts, total_popcount


def _bitsliced_count_ge(bits: List[jax.Array], threshold: int) -> jax.Array:
    """Given a list of uint32 bit-planes, return a plane whose bit is set
    iff >= ``threshold`` of the input planes have that bit set.

    Ripple-carry accumulation into ceil(log2(len+1)) planes; len(bits) is
    dv-1 <= ~8, so this is a handful of XOR/AND ops.
    """
    k = len(bits)
    if threshold <= 0:
        return jnp.full_like(bits[0], 0xFFFFFFFF, dtype=jnp.uint32)
    if threshold > k:
        return jnp.zeros_like(bits[0])
    # ripple-carry add each 1-bit input into sum planes (LSB first)
    planes: List[jax.Array] = []
    for b in bits:
        carry = b
        for i in range(len(planes)):
            planes[i], carry = planes[i] ^ carry, planes[i] & carry
        planes.append(carry)
    # MSB-first lexicographic compare: sum >= threshold
    ge = jnp.zeros_like(bits[0])                                # sum > prefix
    eq = jnp.full_like(bits[0], 0xFFFFFFFF, dtype=jnp.uint32)   # equal so far
    for i in range(len(planes) - 1, -1, -1):
        t_bit = (threshold >> i) & 1
        p = planes[i]
        if t_bit == 0:
            ge = ge | (eq & p)
            eq = eq & ~p
        else:
            eq = eq & p
    return ge | eq


def _flip_at_threshold(others: List[jax.Array], threshold) -> jax.Array:
    """``_bitsliced_count_ge`` with a static OR traced threshold.

    A traced threshold (the per-iteration optimal-switching schedule,
    utils.theory.gallager_b_schedule) selects among the <= dv-1 static
    candidate planes -- the ripple-carry compare itself needs static bit
    tests, and dv is tiny, so compute-all-and-select is the cheap
    formulation.
    """
    if isinstance(threshold, int):
        return _bitsliced_count_ge(others, threshold)
    out = jnp.zeros_like(others[0])
    for b in range(1, len(others) + 1):
        out = jnp.where(threshold == b,
                        _bitsliced_count_ge(others, b), out)
    return out


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class GallagerResult:
    # uint32[n, W] final decision bit planes.  All-zero transmit: set bit
    # = decision error; with ``tx_bits`` given the planes are decision ^
    # tx, so they stay error indicators either way (the soft decoder's
    # convention, ops/soft_bp.SoftBPResult.hard).
    decided: jax.Array
    error_totals: jax.Array  # int32[max_iters+1] decision errors vs transmit
    iterations: jax.Array
    # int32[max_iters+1, B] per-trial error trajectories (reference
    # ``errors`` array per trial); only populated by record="per_trial"
    # -- the expurgated-driver path, which must exclude whole per-trial
    # series by their final count (parallel_simulator_expurgated.py:238).
    traj: jax.Array | None = None

    @property
    def bit_errors(self) -> jax.Array:
        return per_trial_counts(self.decided, axis=0)

    @property
    def failed(self) -> jax.Array:
        unres = jnp.bitwise_or.reduce(self.decided, axis=0)
        bits = ((unres[:, None] >> jnp.arange(32, dtype=jnp.uint32)) & 1)
        return bits.reshape(-1).astype(bool)


def _gallager_iteration(code: LDPCCode, channel: jax.Array, mvc: jax.Array,
                        threshold: int):
    """One flooding round; ``mvc`` is uint32[dc, m, W] socket-major bits.

    Socket-major storage keeps every per-socket plane contiguous (the
    check-major [m, dc, W] layout makes them strided slices -- the same
    layout choice as ops/erasure_bp._check_summaries).
    """
    m, dc, dv = code.m, code.dc, code.dv

    # extrinsic XOR via prefix/suffix scans over contiguous planes
    pre = [jnp.zeros_like(mvc[0])]
    for j in range(dc - 1):
        pre.append(pre[-1] ^ mvc[j])
    suf = [jnp.zeros_like(mvc[0])]
    for j in range(dc - 1, 0, -1):
        suf.append(suf[-1] ^ mvc[j])
    suf.reverse()
    mcv = jnp.stack([pre[j] ^ suf[j] for j in range(dc)])  # [dc, m, W]
    mcv_flat = mcv.reshape(dc * m, -1)

    # gather to variables, one socket at a time: edge e = c*dc + j of
    # variable socket p lives at flat index j*m + c in socket-major layout
    disagree = []
    for p in range(dv):
        e = code.var_to_edge[:, p]
        idx = (e % dc) * m + e // dc
        disagree.append(jnp.take(mcv_flat, idx, axis=0) ^ channel)

    # variable update per outgoing socket p: count disagreements among the
    # other dv-1 incoming messages
    out = []
    for p in range(dv):
        others = [disagree[l] for l in range(dv) if l != p]
        flip = _flip_at_threshold(others, threshold)
        out.append(channel ^ flip)
    out_flat = jnp.stack(out).reshape(dv * code.n, -1)  # [dv*n, W]

    # route back to socket-major check layout: the message on edge
    # (c, j) comes from variable v = chk_to_var[c, j] at its socket
    # p = socket_of_edge(c, j); build p via a scatter of var_to_edge.
    soe = jnp.zeros((code.n * dv,), jnp.int32)
    for p in range(dv):
        soe = soe.at[code.var_to_edge[:, p]].set(p)
    # edge ids for check socket j are e = c*dc + j; p = soe[e]
    new_planes = []
    for j in range(dc):
        e = jnp.arange(m, dtype=jnp.int32) * dc + j
        p = jnp.take(soe, e)
        idx = p * code.n + code.chk_to_var[:, j]
        new_planes.append(jnp.take(out_flat, idx, axis=0))
    new_mvc = jnp.stack(new_planes)  # [dc, m, W]

    # majority decision: flip channel iff > dv/2 of the dv incoming
    # messages disagree
    maj_thresh = dv // 2 + 1
    dec_flip = _bitsliced_count_ge(disagree, maj_thresh)
    decided = channel ^ dec_flip
    return new_mvc, decided


@partial(jax.jit, static_argnames=("max_iters", "threshold", "record"))
def gallager_decode_packed(code: LDPCCode, received: jax.Array,
                           max_iters: int, threshold: int | None = None,
                           schedule: jax.Array | None = None,
                           record: str = "total",
                           tx_bits: jax.Array | None = None
                           ) -> GallagerResult:
    """Decode 32*W BSC trials; ``received`` is uint32[n, W] hard-bit planes
    -- relative to the all-zero codeword by default (bit set = channel
    flipped), or the actual received word when ``tx_bits`` is given.

    ``threshold=None`` selects Gallager-A (t = dv-1); smaller t gives
    Gallager-B variants.  ``schedule`` (int32[>= max_iters], entries
    clamped into [1, dv-1]) overrides ``threshold`` with a per-iteration
    flip threshold -- Gallager's optimal switching rule, computed by
    ``utils.theory.gallager_b_schedule``.  Error counts are decision
    errors vs the transmit after each iteration (index 0 = raw channel
    errors).

    ``tx_bits`` (uint32[n, W] packed transmitted codeword) switches to
    nonzero-codeword error accounting: the decoder runs on the received
    planes verbatim and ``decided``/``error_totals`` hold decision-vs-
    transmit ERROR indicators/counts (the measured BSC channel-symmetry
    check; soft-decoder convention, ops/soft_bp._soft_decode).

    ``record="per_trial"`` additionally fills ``result.traj`` with the
    int32[max_iters+1, B] per-trial error trajectories (~32x the
    counting work; used by the exactly-expurgated driver).
    """
    if schedule is not None:
        schedule = jnp.asarray(schedule, jnp.int32)
        if schedule.shape[0] < max_iters:
            raise ValueError(
                f"schedule has {schedule.shape[0]} entries but max_iters="
                f"{max_iters}; pass at least max_iters thresholds")
        schedule = jnp.clip(schedule[:max_iters], 1, code.dv - 1)
        # A message fixed point under the CURRENT threshold is not a
        # fixed point of the run when a later entry differs -- the early
        # exit below must stay live while any change lies ahead.
        diff = schedule[1:] != schedule[:-1]
        change_ahead = jnp.concatenate(
            [jnp.flip(jnp.cumsum(jnp.flip(diff))) > 0,
             jnp.zeros((1,), bool)])
    if threshold is None:
        threshold = code.dv - 1  # Gallager-A
    channel = received

    def step(mvc, it):
        t = threshold if schedule is None else schedule[it]
        new_mvc, decided = _gallager_iteration(code, channel, mvc, t)
        changed = total_popcount(new_mvc ^ mvc) > 0
        if schedule is not None:
            changed = changed | change_ahead[it]
        return new_mvc, decided, changed

    mvc0 = jnp.stack([jnp.take(received, code.chk_to_var[:, j], axis=0)
                      for j in range(code.dc)])  # [dc, m, W] socket-major
    return _gallager_loop(mvc0, received, step, max_iters, record, tx_bits)


def _gallager_loop(mvc0, received, step, max_iters: int, record: str,
                   tx_bits) -> GallagerResult:
    """Shared flooding loop of the regular and irregular Gallager
    decoders.  ``step(mvc, it) -> (new_mvc, decided, changed)``.

    Termination: message fixed point (Gallager decoding is not monotone,
    so unlike the BEC an unchanged *count* does not imply convergence --
    the messages themselves must be unchanged) or error-free decision.
    Error counts are vs the transmit (``tx_bits`` packed planes; None =
    all-zero); ``record`` selects int32[it+1] totals or
    int32[it+1, B] per-trial trajectories (see GallagerResult.traj).
    """
    if record not in ("total", "per_trial"):
        raise ValueError(f"unknown record mode {record!r}")
    as_err = (lambda d: d) if tx_bits is None else (lambda d: d ^ tx_bits)
    if record == "total":
        counts_of = lambda d: total_popcount(as_err(d)).astype(jnp.int32)
    else:
        counts_of = lambda d: per_trial_counts(as_err(d), axis=0)

    c0 = counts_of(received)
    total0 = jnp.sum(c0)
    errors = jnp.zeros((max_iters + 1,) + c0.shape, jnp.int32).at[0].set(c0)

    def cond(carry):
        _, _, _, it, total, changed = carry
        return (it < max_iters) & (total > 0) & changed

    def body(carry):
        mvc, decided, errors, it, _, _ = carry
        new_mvc, decided, changed = step(mvc, it)
        c = counts_of(decided)
        errors = errors.at[it + 1].set(c)
        return (new_mvc, decided, errors, it + 1, jnp.sum(c), changed)

    mvc, decided, errors, it, _, _ = jax.lax.while_loop(
        cond, body,
        (mvc0, received, errors, jnp.int32(0), total0, total0 > -1))

    final = counts_of(decided)
    tail = jnp.arange(max_iters + 1) > it
    errors = jnp.where(tail.reshape((-1,) + (1,) * final.ndim), final,
                       errors)
    if record == "per_trial":
        return GallagerResult(decided=as_err(decided),
                              error_totals=jnp.sum(errors, axis=1),
                              iterations=it, traj=errors)
    return GallagerResult(decided=as_err(decided), error_totals=errors,
                          iterations=it)


# ---------------------------------------------------------------------------
# Irregular codes: phantom-padded Gallager-A/B.
#
# Same phantom discipline as the BEC/soft decoders (models/irregular.py):
# the phantom variable's channel bit is 0 and every padded socket's
# message stays identically 0, so the check-side extrinsic XOR needs no
# masks; the variable side masks phantom-routed messages to "agree" and
# applies PER-DEGREE thresholds (a degree-d node has d-1 extrinsic
# inputs): flip threshold t_d = min(b, d-1) (b=None -> Gallager-A's
# t_d = d-1) and majority decision t = d//2 + 1.
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("max_iters", "threshold", "record"))
def gallager_decode_packed_irregular(code, received: jax.Array,
                                     max_iters: int,
                                     threshold: int | None = None,
                                     record: str = "total",
                                     tx_bits: jax.Array | None = None
                                     ) -> GallagerResult:
    """Gallager-A/B for an :class:`..models.irregular.IrregularLDPCCode`.

    ``received`` is uint32[n, W] hard-bit planes (flips vs the all-zero
    word, or the received word itself with ``tx_bits`` -- same contract
    as :func:`gallager_decode_packed`, including ``record``);
    ``threshold=None`` -> per-degree Gallager-A (flip iff all d-1 others
    disagree); an int b applies t_d = min(b, d-1) per degree (the same
    clamp ``utils.theory.irregular_gallager_b_density_evolution`` uses).
    Returns [n, W] planes.  Oracle-grade path (per-degree selects); the
    bit-packed layout still makes it a vector decoder.
    """
    n, m = code.n, code.m
    dv_max, dc_max = code.dv_max, code.dc_max
    m_pad = m + 1
    channel = jnp.concatenate(
        [received, jnp.zeros((1,) + received.shape[1:], received.dtype)])
    full = jnp.uint32(0xFFFFFFFF)
    var_mask_bits = [jnp.where(code.var_mask[:, p:p + 1], full,
                               jnp.uint32(0)) for p in range(dv_max)]
    # per-socket routing: variable socket p -> flat mcv row j*(m+1)+c
    sock = code.var_to_sock
    route = [(sock[:, p] % dc_max) * m_pad + sock[:, p] // dc_max
             for p in range(dv_max)]
    degrees = jnp.sum(code.var_mask, axis=1).astype(jnp.int32)  # [n+1]
    # all candidate degrees (static, so the whole decoder jits); masks of
    # absent degrees are all-zero and cost a handful of fused selects
    present = list(range(1, dv_max + 1))
    deg_bits = {d: jnp.where((degrees == d)[:, None], full, jnp.uint32(0))
                for d in present}

    # loop-invariant back-routing: check socket (c, j) reads variable
    # v = chk_to_var[c, j] at socket p with var_to_sock[v, p] == c*dc_max+j
    inv_p = jnp.zeros((m_pad * dc_max,), jnp.int32)
    for p in range(dv_max):
        inv_p = inv_p.at[sock[:, p]].set(p)

    # initial messages: the channel bit at every socket (phantom rows 0)
    mvc0 = jnp.stack([jnp.take(channel, code.chk_to_var[:, j], axis=0)
                      for j in range(dc_max)])   # [dc_max, m+1, W]

    def per_degree_flip(others, rule):
        """Combine per-degree thresholds over the padded-socket counts."""
        out = jnp.zeros_like(others[0])
        for d in present:
            out = out | (deg_bits[d] & _bitsliced_count_ge(others, rule(d)))
        return out

    def iteration(mvc):
        # check extrinsic XOR (padded messages are 0 -> maskless)
        pre = [jnp.zeros_like(mvc[0])]
        for j in range(dc_max - 1):
            pre.append(pre[-1] ^ mvc[j])
        suf = [jnp.zeros_like(mvc[0])]
        for j in range(dc_max - 1, 0, -1):
            suf.append(suf[-1] ^ mvc[j])
        suf.reverse()
        mcv = jnp.stack([pre[j] ^ suf[j] for j in range(dc_max)])
        mcv_flat = mcv.reshape(dc_max * m_pad, -1)

        disagree = [(jnp.take(mcv_flat, route[p], axis=0) ^ channel)
                    & var_mask_bits[p] for p in range(dv_max)]

        # per-degree flip rule; degree-1 nodes have no extrinsic input
        # and never flip (t clamped to >= 1 over zero maskable counts)
        rule = (lambda d: max(d - 1, 1)) if threshold is None else \
            (lambda d: min(threshold, max(d - 1, 1)))
        out = []
        for p in range(dv_max):
            others = [disagree[l] for l in range(dv_max) if l != p]
            flip = per_degree_flip(others, rule)
            out.append(channel ^ flip)
        out_flat = jnp.stack(out).reshape(dv_max * (n + 1), -1)

        new_planes = []
        for j in range(dc_max):
            pos = jnp.arange(m_pad, dtype=jnp.int32) * dc_max + j
            p = jnp.take(inv_p, pos)
            idx = p * (n + 1) + code.chk_to_var[:, j]
            plane = jnp.take(out_flat, idx, axis=0)
            # padded sockets (phantom variable) must stay 0
            new_planes.append(jnp.where(code.chk_mask[:, j:j + 1], plane,
                                        jnp.uint32(0)))
        new_mvc = jnp.stack(new_planes)

        dec_flip = per_degree_flip(disagree, lambda d: d // 2 + 1)
        decided = (channel ^ dec_flip)[:-1]
        return new_mvc, decided

    def step(mvc, it):
        new_mvc, decided = iteration(mvc)
        return new_mvc, decided, total_popcount(new_mvc ^ mvc) > 0

    return _gallager_loop(mvc0, received, step, max_iters, record, tx_bits)
