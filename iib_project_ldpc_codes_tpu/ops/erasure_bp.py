"""BEC erasure message-passing (BP) decoder.

Re-designs the reference's native hot loop (message_passing.c:7-82) as an
edge-parallel gather program:

  * Check -> variable: the extrinsic message at socket j of a check is the
    XOR of the other dc-1 incoming variable values, *valid* only when all of
    them are known (message_passing.c:24-45).  Instead of the reference's
    O(dc^2) leave-one-out inner loop, prefix/suffix AND (validity) and XOR
    (parity) scans over the static socket axis compute all dc extrinsic
    outputs in O(dc).
  * Variable -> check: an erased variable adopts any valid incoming message
    (message_passing.c:52-65); resolved variables never change (monotone).
    This is a gather of edge messages via ``var_to_edge`` followed by an
    OR-reduction -- no scatter.

Termination reproduces the reference exactly but in batch form: on the BEC
the known-set only grows, so "erasure count unchanged for one iteration" is
a fixed point; the reference's stall shortcut (message_passing.c:16-19)
copies the count forward and its convergence break (message_passing.c:76-78)
leaves the remaining error entries zero.  Here a ``lax.while_loop`` runs
until the global fixed point and the error trajectory tail is filled with
the final count -- bitwise-identical aggregate semantics.

Two implementations:

  * :func:`bp_decode` -- one codeword in the {0,1,2} alphabet; the readable
    reference/oracle path (vmap-able).
  * :func:`bp_decode_packed` -- the production path: 32 Monte Carlo trials
    per uint32 word, batch in the trailing (lane) dimension, all message
    algebra as bitwise integer ops.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from ..models.code import LDPCCode
from .bitops import per_trial_counts, total_popcount
from .channels import ERASURE


def _check_packed_batch_bits(n: int, words: int) -> None:
    """Loud trace-time guard: the packed decoders' counters (error
    totals, fixed-point detection) are exact int32, so a batch whose
    total bit count reaches 2^31 is out of contract -- a worst-case
    erasure count would wrap and the result arrays could not hold the
    true totals (observed failure mode before this guard: the while
    loop saw a negative total and exited at iteration 0).  Split such
    workloads into chunks; the Monte Carlo engine accumulates chunk
    counters into int64 on the host.
    """
    total = n * words * 32
    if total >= 2 ** 31:
        raise ValueError(
            f"packed batch of {total} total bits (n={n}, words={words}) "
            "exceeds the exact-int32 counter range (2^31); split the "
            "batch into chunks")


def _run_to_fixed_point(state, step, counts_of, max_iters: int):
    """Shared while_loop scaffold of every BEC BP decode in this module.

    Runs ``state = step(state)`` until the summed error count is
    unchanged for one round (on the BEC the known-set only grows, so an
    unchanged count IS the fixed point), hits zero, or the budget runs
    out -- the reference's termination (message_passing.c:16-19, :76-78)
    in batch form.  ``counts_of(state)`` returns the per-round error
    record: an int32 scalar (aggregate decoders) or int32[B] (the
    per-trial-trajectory decoder); its shape sets the error array's.

    Returns ``(state, errors[max_iters+1, ...], iterations)`` with the
    trajectory tail filled with the final counts (stalled failures keep
    their count, converged trials contribute zeros) -- bitwise the
    reference's aggregate error-array semantics.

    One implementation instead of four copies: a termination-semantics
    bug needs fixing exactly once (round-4 verdict item 8); the
    packed==naive and compiled-reference-C parity tests pin the
    semantics bit-exactly.
    """
    c0 = counts_of(state)
    total0 = jnp.sum(c0)
    errors = jnp.zeros((max_iters + 1,) + c0.shape, jnp.int32).at[0].set(c0)

    def cond(carry):
        _, _, it, total, changed = carry
        return (it < max_iters) & changed & (total > 0)

    def body(carry):
        state, errors, it, total, _ = carry
        state = step(state)
        c = counts_of(state)
        new_total = jnp.sum(c)
        errors = errors.at[it + 1].set(c)
        return (state, errors, it + 1, new_total, new_total != total)

    state, errors, it, _, _ = jax.lax.while_loop(
        cond, body, (state, errors, jnp.int32(0), total0, total0 > -1))

    final = counts_of(state)
    tail = jnp.arange(max_iters + 1) > it
    errors = jnp.where(tail.reshape((-1,) + (1,) * final.ndim), final,
                       errors)
    return state, errors, it


# ---------------------------------------------------------------------------
# Naive single-codeword implementation ({0,1,2} alphabet) -- the oracle.
# ---------------------------------------------------------------------------

def _bp_iteration(code: LDPCCode, val: jax.Array, known: jax.Array):
    """One parallel BP round: returns updated (val, known)."""
    row_val = val[code.chk_to_var]      # [m, dc]
    row_kn = known[code.chk_to_var]     # [m, dc]
    cnt = jnp.sum(row_kn, axis=1, keepdims=True)          # [m, 1]
    xor_all = jnp.bitwise_xor.reduce(row_val & row_kn, axis=1, keepdims=True)
    others_known = (cnt - row_kn) == (code.dc - 1)        # [m, dc]
    mcv_val = jnp.bitwise_xor(xor_all, row_val & row_kn)  # extrinsic XOR

    e_valid = others_known.reshape(-1)[code.var_to_edge]  # [n, dv]
    e_val = mcv_val.reshape(-1)[code.var_to_edge]         # [n, dv]
    any_valid = jnp.any(e_valid, axis=1)
    adopt = jnp.any(e_valid & (e_val == 1), axis=1).astype(val.dtype)

    new_known = known | any_valid
    new_val = jnp.where(known, val, adopt * any_valid)
    return new_val, new_known


@partial(jax.jit, static_argnames=("max_iters",))
def bp_decode(code: LDPCCode, channel_output: jax.Array, max_iters: int
              ) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Decode one codeword in the {0,1,2} wire format.

    Returns ``(decoded, errors, iterations)`` where ``decoded`` is {0,1,2}
    (2 = still erased), ``errors`` has length ``max_iters + 1`` with
    ``errors[0]`` the initial erasure count and ``errors[t]`` the count
    after round ``t`` (parallel_simulator.py:147-166 semantics: tail is the
    stalled count for failures, zeros after convergence), and ``iterations``
    is the number of rounds actually computed.
    """
    channel_output = jnp.asarray(channel_output, jnp.int32)
    known0 = channel_output != ERASURE
    val0 = jnp.where(known0, channel_output, 0)
    (val, known), errors, it = _run_to_fixed_point(
        (val0, known0),
        lambda s: _bp_iteration(code, *s),
        lambda s: jnp.sum(~s[1]).astype(jnp.int32), max_iters)
    decoded = jnp.where(known, val, ERASURE)
    return decoded, errors, it


# ---------------------------------------------------------------------------
# Bit-packed batched implementation (32 trials per uint32, lanes = batch).
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PackedBPResult:
    """Result of a packed batch decode of B = 32*W trials."""

    val: jax.Array        # uint32[n, W] decoded bit planes (valid where known)
    known: jax.Array      # uint32[n, W] resolved mask
    error_totals: jax.Array  # int32[max_iters+1] erased bits summed over batch
    iterations: jax.Array    # int32, rounds computed before fixed point

    @property
    def failed(self) -> jax.Array:
        """bool[B]: trials with at least one unresolved erasure."""
        unresolved = jnp.bitwise_or.reduce(~self.known, axis=0)  # [W]
        bits = ((unresolved[:, None] >> jnp.arange(32, dtype=jnp.uint32)) & 1)
        return bits.reshape(-1).astype(bool)

    @property
    def bit_errors(self) -> jax.Array:
        """int32[B]: unresolved erasures per trial (final errors[-1])."""
        return per_trial_counts(~self.known, axis=0)


def _check_summaries(code: LDPCCode, val: jax.Array, known: jax.Array):
    """Per-check round summaries: (exactly_one_unknown, xor_known).

    Key identity: the only socket whose extrinsic message matters is an
    *unknown* variable, and an unknown variable contributes nothing to the
    masked XOR -- so the leave-one-out per-edge arrays of the reference
    (message_passing.c:24-45) collapse to two per-check words per lane:

      exactly_one[c] : exactly one participant unknown (that participant's
                       extrinsic inputs are then all known),
      xor_known[c]   : XOR of the known participants' values = the value
                       the unique unknown must take.

    This shrinks the variable-side gather table from [m*dc, W] to [m, W]
    (6x smaller at dc=6) and skips materialising any per-edge message
    array.
    """
    # Per-socket gathers ([m, W] each) instead of one [E, W] gather +
    # reshape: the [m, dc, W] intermediate makes kn[:, j] a strided
    # access, while each per-socket plane is contiguous.
    dc = code.dc
    kns = [jnp.take(known, code.chk_to_var[:, j], axis=0)
           for j in range(dc)]
    full = jnp.uint32(0xFFFFFFFF)
    pre = [jnp.full_like(kns[0], full)]
    for j in range(dc - 1):
        pre.append(pre[-1] & kns[j])
    suf = [jnp.full_like(kns[0], full)]
    for j in range(dc - 1, 0, -1):
        suf.append(suf[-1] & kns[j])
    suf.reverse()
    exactly_one = jnp.zeros_like(kns[0])
    for j in range(dc):
        exactly_one = exactly_one | (~kns[j] & pre[j] & suf[j])

    if val is None:
        return exactly_one, None
    xor_known = jnp.zeros_like(exactly_one)
    for j in range(dc):
        vl_j = jnp.take(val, code.chk_to_var[:, j], axis=0)
        xor_known = xor_known ^ (vl_j & kns[j])
    return exactly_one, xor_known


def _gather_or_by_variable(code: LDPCCode, table: jax.Array) -> jax.Array:
    """OR over each variable's adjacent checks of a per-check plane."""
    acc = jnp.take(table, code.var_to_chk[:, 0], axis=0)
    for j in range(1, code.dv):
        acc = acc | jnp.take(table, code.var_to_chk[:, j], axis=0)
    return acc


def _packed_iteration(code: LDPCCode, val: jax.Array, known: jax.Array):
    """One parallel BP round on packed state; pure bitwise ops."""
    exactly_one, xor_known = _check_summaries(code, val, known)
    # a ready check adjacent to an *unknown* v must have v as its unique
    # unknown; for known v lanes the update is masked out below
    any_ready = _gather_or_by_variable(code, exactly_one)
    adopt = _gather_or_by_variable(code, exactly_one & xor_known)
    new_known = known | any_ready
    new_val = val | (adopt & ~known)
    return new_val, new_known


@partial(jax.jit, static_argnames=("max_iters",))
def bp_decode_packed(code: LDPCCode, erased: jax.Array, tx_bits: jax.Array,
                     max_iters: int) -> PackedBPResult:
    """Decode 32*W trials at once on one code.

    Args:
      code: the LDPC code (single code; vmap for per-trial fresh codes).
      erased: uint32[n, W] packed erasure indicators (1 = erased), e.g. from
        :func:`..channels.bec_packed_channel`.
      tx_bits: uint32[n, W] packed transmitted bits (all-zero codeword ->
        zeros, the reference default, parallel_simulator.py:222).
      max_iters: BP iteration budget (50-200 in the reference envelope).
    """
    _check_packed_batch_bits(code.n, erased.shape[1])
    known = ~erased
    val = tx_bits & known
    # count the erased bits directly -- `n*W*32 - popcount(known)` would
    # overflow the int32 operand once the batch exceeds 2^31 total bits
    # (hit at n=1e5 x 768 words), while the erased count itself is small
    (val, known), errors, it = _run_to_fixed_point(
        (val, known),
        lambda s: _packed_iteration(code, *s),
        lambda s: total_popcount(~s[1]).astype(jnp.int32),
        max_iters)
    return PackedBPResult(val=val, known=known, error_totals=errors,
                          iterations=it)


def _packed_iteration_allzero(code: LDPCCode, known: jax.Array) -> jax.Array:
    """One BP round tracking only the known-mask (all-zero transmit).

    Every reference simulation sends the all-zero codeword
    (parallel_simulator.py:222, simulator.py:253), so the value planes stay
    identically zero and the round is pure validity propagation via the
    per-check exactly-one-unknown summary (see :func:`_check_summaries`).
    """
    exactly_one, _ = _check_summaries(code, None, known)
    return known | _gather_or_by_variable(code, exactly_one)


@partial(jax.jit, static_argnames=("max_iters",))
def bp_decode_packed_allzero(code: LDPCCode, erased: jax.Array,
                             max_iters: int) -> PackedBPResult:
    """All-zero-codeword fast path of :func:`bp_decode_packed`.

    Bit-identical statistics (error trajectories, block/bit errors) at
    roughly half the per-iteration HBM traffic; ``val`` in the result is
    the all-zero plane.
    """
    _check_packed_batch_bits(code.n, erased.shape[1])
    known, errors, it = _run_to_fixed_point(
        ~erased,
        lambda kn: _packed_iteration_allzero(code, kn),
        lambda kn: total_popcount(~kn).astype(jnp.int32),
        max_iters)
    return PackedBPResult(val=jnp.zeros_like(known), known=known,
                          error_totals=errors, iterations=it)


@partial(jax.jit, static_argnames=("max_iters",))
def bp_decode_packed_traj(code: LDPCCode, erased: jax.Array,
                          tx_bits: jax.Array, max_iters: int
                          ) -> Tuple[PackedBPResult, jax.Array]:
    """Packed decode that also records *per-trial* error trajectories.

    Returns ``(result, traj)`` with ``traj`` int32[max_iters+1, B]: the
    erasure count of each trial after each iteration (reference ``errors``
    array per trial, parallel_simulator.py:147-166).  ~32x more counting
    work per iteration than :func:`bp_decode_packed`; used by the
    expurgated-ensemble driver, which must exclude whole per-trial
    trajectories based on the final count
    (parallel_simulator_expurgated.py:238-243).
    """
    _check_packed_batch_bits(code.n, erased.shape[1])
    known = ~erased
    val = tx_bits & known
    (val, known), traj, it = _run_to_fixed_point(
        (val, known),
        lambda s: _packed_iteration(code, *s),
        lambda s: per_trial_counts(~s[1], axis=0), max_iters)
    result = PackedBPResult(val=val, known=known,
                            error_totals=jnp.sum(traj, axis=1),
                            iterations=it)
    return result, traj


# ---------------------------------------------------------------------------
# Irregular codes: phantom-padded reuse of the packed kernels.
#
# models/irregular.py pads check rows to dc_max with a phantom variable n
# (kept permanently known, value 0) and variable rows to dv_max with a
# phantom check m (all-phantom participants => exactly_one == 0), so the
# *regular* packed iteration above runs verbatim on [n+1, W] state planes:
# no masks, no selects, same per-socket contiguous-plane gathers.  This
# generalises message_passing.c:7-82 beyond regular degrees.
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class _PhantomView:
    """Regular-decoder view of an irregular code (duck-typed LDPCCode).

    ``n`` counts the phantom row, ``dv``/``dc`` are the padded maxima;
    ``var_to_chk`` is a direct field (LDPCCode derives it from
    var_to_edge, but the kernels only read the attribute).
    """

    chk_to_var: jax.Array   # int32[m+1, dc_max]
    var_to_chk: jax.Array   # int32[n+1, dv_max]
    n: int = dataclasses.field(metadata=dict(static=True))
    dv: int = dataclasses.field(metadata=dict(static=True))
    dc: int = dataclasses.field(metadata=dict(static=True))


def _phantom_view(code) -> _PhantomView:
    return _PhantomView(chk_to_var=code.chk_to_var,
                        var_to_chk=code.var_to_chk,
                        n=code.n + 1, dv=code.dv_max, dc=code.dc_max)


def _pad_phantom_row(plane: jax.Array) -> jax.Array:
    """Append the phantom variable's plane (all zero: not erased)."""
    return jnp.concatenate(
        [plane, jnp.zeros((1,) + plane.shape[1:], plane.dtype)], axis=0)


def _strip_phantom(res: PackedBPResult) -> PackedBPResult:
    return PackedBPResult(val=res.val[:-1], known=res.known[:-1],
                          error_totals=res.error_totals,
                          iterations=res.iterations)


@partial(jax.jit, static_argnames=("max_iters",))
def bp_decode_packed_irregular(code, erased: jax.Array, tx_bits: jax.Array,
                               max_iters: int) -> PackedBPResult:
    """:func:`bp_decode_packed` for an :class:`..models.irregular
    .IrregularLDPCCode`; identical semantics, [n, W] planes."""
    res = bp_decode_packed(_phantom_view(code), _pad_phantom_row(erased),
                           _pad_phantom_row(tx_bits), max_iters)
    return _strip_phantom(res)


@partial(jax.jit, static_argnames=("max_iters",))
def bp_decode_packed_allzero_irregular(code, erased: jax.Array,
                                       max_iters: int) -> PackedBPResult:
    """All-zero-codeword fast path for irregular codes."""
    res = bp_decode_packed_allzero(_phantom_view(code),
                                   _pad_phantom_row(erased), max_iters)
    return _strip_phantom(res)


@partial(jax.jit, static_argnames=("max_iters",))
def bp_decode_packed_traj_irregular(code, erased: jax.Array,
                                    tx_bits: jax.Array, max_iters: int):
    """Per-trial-trajectory variant for irregular codes."""
    res, traj = bp_decode_packed_traj(
        _phantom_view(code), _pad_phantom_row(erased),
        _pad_phantom_row(tx_bits), max_iters)
    return _strip_phantom(res), traj


@partial(jax.jit, static_argnames=("max_iters",))
def bp_decode_irregular(code, channel_output: jax.Array, max_iters: int
                        ) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Single-codeword {0,1,2} oracle decoder for irregular codes.

    Mirrors :func:`bp_decode` semantics (same return triple).  Unlike the
    packed path this one needs explicit per-socket masks: the per-edge
    "all other participants known" validity of the naive formulation is
    (vacuously) true for the all-known phantom check, so its zero-valued
    messages must be masked off rather than padded away.
    """
    channel_output = jnp.asarray(channel_output, jnp.int32)
    known0 = jnp.concatenate([channel_output != ERASURE,
                              jnp.ones((1,), bool)])
    val0 = jnp.where(known0, jnp.concatenate([channel_output,
                                              jnp.zeros((1,), jnp.int32)]), 0)
    var_mask = code.var_mask          # bool[n+1, dv_max]

    def iteration(val, known):
        row_val = val[code.chk_to_var]       # [m+1, dc_max]
        row_kn = known[code.chk_to_var]
        cnt = jnp.sum(row_kn, axis=1, keepdims=True)
        xor_all = jnp.bitwise_xor.reduce(row_val & row_kn, axis=1,
                                         keepdims=True)
        others_known = (cnt - row_kn) == (code.dc_max - 1)
        mcv_val = jnp.bitwise_xor(xor_all, row_val & row_kn)

        e_valid = others_known.reshape(-1)[code.var_to_sock] & var_mask
        e_val = mcv_val.reshape(-1)[code.var_to_sock]
        any_valid = jnp.any(e_valid, axis=1)
        adopt = jnp.any(e_valid & (e_val == 1), axis=1).astype(val.dtype)
        new_known = known | any_valid
        new_val = jnp.where(known, val, adopt * any_valid)
        return new_val, new_known

    (val, known), errors, it = _run_to_fixed_point(
        (val0, known0),
        lambda s: iteration(*s),
        lambda s: jnp.sum(~s[1]).astype(jnp.int32), max_iters)
    decoded = jnp.where(known, val, ERASURE)[:-1]
    return decoded, errors, it
