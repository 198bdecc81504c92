"""BEC peeling decoder with R-process (degree-1 evolution) tracking.

Reference semantics (peeling_decoder.py:47-82): strip non-erased variables
from the residual graph, then repeatedly pick a *uniformly random* degree-1
check, resolve its unique remaining variable, and peel its column, recording
the number of degree-1 checks before each peel (``one_degree_evolution`` --
the R-process of finite-length scaling theory).  The decoder fails when
degree-1 checks run out with erasures remaining.

Device design: the sequential peel (which must stay sequential -- the statistic
of interest *is* the one-at-a-time trajectory) is a ``lax.scan`` of masked
steps with static length, vmapped over a batch of trials; degree counts are
recomputed per step as a gather (no scatter).  The random degree-1 choice
uses the Gumbel-argmax trick with a threaded key, reproducing the
reference's ``np.random.choice`` (peeling_decoder.py:66) reproducibly.

A parallel variant (resolve *all* degree-1 checks per super-step) is also
provided; it changes the trajectory statistics (SURVEY.md section 7 step 6)
but reaches the same final set -- on the BEC, peeling and BP share fixed
points (the maximal stopping set), which the tests exploit as an oracle.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from ..models.code import LDPCCode
from .channels import ERASURE


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PeelResult:
    """Result of one peeling decode."""

    unresolved: jax.Array        # bool[n]: erasures never resolved
    one_degree_evolution: jax.Array  # int32[max_steps+1]; valid entries only
    steps: jax.Array             # int32: peels performed (+1 if final 0 logged)
    num_erasures: jax.Array      # int32: initial erasure count

    @property
    def success(self) -> jax.Array:
        return ~jnp.any(self.unresolved)

    @property
    def remaining(self) -> jax.Array:
        return jnp.sum(self.unresolved).astype(jnp.int32)

    @property
    def size_at_failure(self) -> jax.Array:
        """Reference's ``sizes_at_failure`` bookkeeping: initial erasures
        + 1 - trajectory length (peeling_decoder.py:143): remaining+1 for
        failures, 0 for successes."""
        return self.num_erasures + 1 - self.steps


def _check_degrees(code: LDPCCode, unresolved: jax.Array) -> jax.Array:
    """int32[m]: number of unresolved erased variables in each check."""
    return jnp.sum(unresolved[code.chk_to_var], axis=1).astype(jnp.int32)


@partial(jax.jit, static_argnames=("max_steps",))
def peel_decode(code: LDPCCode, channel_output: jax.Array, key: jax.Array,
                max_steps: int | None = None) -> PeelResult:
    """Sequential random peeling of one codeword in the {0,1,2} format.

    ``one_degree_evolution[t]`` is the degree-1 check count before peel t;
    if decoding completes, one extra 0 entry is recorded (the reference's
    final append, peeling_decoder.py:79-80).  Entries past ``steps`` are -1.
    """
    channel_output = jnp.asarray(channel_output, jnp.int32)
    unresolved0 = channel_output == ERASURE
    num_erasures = jnp.sum(unresolved0).astype(jnp.int32)
    if max_steps is None:
        max_steps = code.n

    def step(carry, step_key):
        unresolved, done = carry
        deg = _check_degrees(code, unresolved)
        ones = deg == 1
        count = jnp.sum(ones).astype(jnp.int32)
        active = (count > 0) & ~done
        # Gumbel-argmax = uniform choice among degree-1 checks
        g = jax.random.gumbel(step_key, deg.shape)
        score = jnp.where(ones, g, -jnp.inf)
        chosen = jnp.argmax(score)
        row = code.chk_to_var[chosen]                       # [dc]
        un_row = unresolved[row]
        var = row[jnp.argmax(un_row)]
        unresolved = unresolved.at[var].set(
            jnp.where(active, False, unresolved[var]))
        recorded = jnp.where(active, count, -1)
        return (unresolved, done | ~active), recorded

    keys = jax.random.split(key, max_steps)
    (unresolved, _), counts = jax.lax.scan(
        step, (unresolved0, num_erasures == 0), keys)

    steps = jnp.sum(counts >= 0).astype(jnp.int32)
    # Reference appends a final 0 when fully decoded (peeling_decoder.py:79)
    success = ~jnp.any(unresolved)
    evolution = jnp.concatenate([counts, jnp.full((1,), -1, jnp.int32)])
    evolution = jnp.where(
        (jnp.arange(max_steps + 1) == steps) & success, 0, evolution)
    steps = steps + success.astype(jnp.int32)
    return PeelResult(unresolved=unresolved, one_degree_evolution=evolution,
                      steps=steps, num_erasures=num_erasures)


@partial(jax.jit, static_argnames=("max_steps",))
def peel_decode_irregular(code, channel_output: jax.Array, key: jax.Array,
                          max_steps: int | None = None) -> PeelResult:
    """:func:`peel_decode` for an :class:`..models.irregular
    .IrregularLDPCCode` -- identical R-process semantics.

    Phantom padding does the masking: the state vector gains a phantom
    row (index n, never erased), so padded check sockets contribute no
    degree and are never 'the unique unresolved participant'; the
    phantom check row has degree 0 and is never selected.
    """
    channel_output = jnp.asarray(channel_output, jnp.int32)
    un_ext0 = jnp.concatenate([channel_output == ERASURE,
                               jnp.zeros((1,), bool)])   # [n+1]
    num_erasures = jnp.sum(un_ext0).astype(jnp.int32)
    if max_steps is None:
        max_steps = code.n
    chk = code.chk_to_var                                 # [m+1, dc_max]

    def step(carry, step_key):
        un_ext, done = carry
        deg = jnp.sum(un_ext[chk], axis=1).astype(jnp.int32)  # [m+1]
        ones = deg == 1
        count = jnp.sum(ones).astype(jnp.int32)
        active = (count > 0) & ~done
        g = jax.random.gumbel(step_key, deg.shape)
        chosen = jnp.argmax(jnp.where(ones, g, -jnp.inf))
        row = chk[chosen]                                 # [dc_max]
        var = row[jnp.argmax(un_ext[row])]
        un_ext = un_ext.at[var].set(
            jnp.where(active, False, un_ext[var]))
        return (un_ext, done | ~active), jnp.where(active, count, -1)

    keys = jax.random.split(key, max_steps)
    (un_ext, _), counts = jax.lax.scan(
        step, (un_ext0, num_erasures == 0), keys)

    steps = jnp.sum(counts >= 0).astype(jnp.int32)
    unresolved = un_ext[:-1]
    success = ~jnp.any(unresolved)
    evolution = jnp.concatenate([counts, jnp.full((1,), -1, jnp.int32)])
    evolution = jnp.where(
        (jnp.arange(max_steps + 1) == steps) & success, 0, evolution)
    steps = steps + success.astype(jnp.int32)
    return PeelResult(unresolved=unresolved, one_degree_evolution=evolution,
                      steps=steps, num_erasures=num_erasures)


def peel_decode_batch(code: LDPCCode, channel_outputs: jax.Array,
                      key: jax.Array, max_steps: int | None = None
                      ) -> PeelResult:
    """vmap of :func:`peel_decode` over a leading batch axis."""
    batch = channel_outputs.shape[0]
    keys = jax.random.split(key, batch)
    return jax.vmap(lambda rx, k: peel_decode(code, rx, k, max_steps))(
        channel_outputs, keys)


@partial(jax.jit, static_argnames=("max_rounds",))
def peel_decode_parallel(code: LDPCCode, channel_output: jax.Array,
                         max_rounds: int = 0) -> Tuple[jax.Array, jax.Array]:
    """Super-step peeling: resolve every degree-1 check each round.

    Returns ``(unresolved, rounds)``.  Round count differs from the
    sequential trajectory but the final unresolved set is the same maximal
    stopping set BP converges to.
    """
    channel_output = jnp.asarray(channel_output, jnp.int32)
    unresolved0 = channel_output == ERASURE
    max_rounds = max_rounds or code.n

    def cond(carry):
        unresolved, rounds, changed = carry
        return changed & (rounds < max_rounds)

    def body(carry):
        unresolved, rounds, _ = carry
        deg = _check_degrees(code, unresolved)
        ones = deg == 1                                     # [m]
        # a variable is resolved if any adjacent check has degree 1 and the
        # variable is its unique unresolved participant
        ones_edge = jnp.repeat(ones, code.dc)               # [E] by check
        e_hits = ones_edge[code.var_to_edge]                # [n, dv]
        resolved_now = jnp.any(e_hits, axis=1) & unresolved
        new_unresolved = unresolved & ~resolved_now
        changed = jnp.any(resolved_now)
        return new_unresolved, rounds + 1, changed

    unresolved, rounds, _ = jax.lax.while_loop(
        cond, body, (unresolved0, jnp.int32(0), jnp.any(unresolved0)))
    return unresolved, rounds
