"""Edge-list LDPC code container.

The reference stores codes three ways at once: a dense boolean parity-check
matrix, a flattened check->variable lookup and a flattened variable->check
lookup (random_code_generator.c:21-64, parallel_simulator.py:131-146).  This
design keeps only the edge-list form as the primary structure and
derives everything else from it:

  * ``chk_to_var[m, dc]``  -- variable index at each check socket.  Edge ``e``
    (row-major position in this array) belongs to check ``e // dc``.
  * ``var_to_edge[n, dv]`` -- for each variable, the edge ids of its sockets
    (ascending).  Because edge ids ascend with check index, this reproduces
    the reference's variable_lookup ordering (random_code_generator.c:53-63).

Both BP update directions are then pure gathers with static index arrays:
check updates gather node values via ``chk_to_var``; variable updates gather
edge messages via ``var_to_edge``.  No scatter is ever needed: every
update is a batched gather that XLA fuses with its bitwise consumers.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class LDPCCode:
    """A (dv,dc)-regular LDPC code in edge-list form.

    Array fields are pytree leaves (so ``LDPCCode`` passes through ``jit`` /
    ``vmap`` / ``shard_map``); the degree parameters are static metadata.
    """

    chk_to_var: jax.Array  # int32[m, dc]: variable index per check socket
    var_to_edge: jax.Array  # int32[n, dv]: flattened edge id per variable socket
    n: int = dataclasses.field(metadata=dict(static=True))
    dv: int = dataclasses.field(metadata=dict(static=True))
    dc: int = dataclasses.field(metadata=dict(static=True))

    @property
    def m(self) -> int:
        """Number of check nodes (= rows of H)."""
        return (self.n * self.dv) // self.dc

    @property
    def k(self) -> int:
        """Design dimension k = n(dc-dv)/dc (parallel_simulator.py:179)."""
        return self.n * (self.dc - self.dv) // self.dc

    @property
    def rate(self) -> float:
        return self.k / self.n

    @property
    def num_edges(self) -> int:
        return self.n * self.dv

    @property
    def var_to_chk(self) -> jax.Array:
        """int32[n, dv]: check index per variable socket (reference
        variable_lookup, random_code_generator.c:59)."""
        return self.var_to_edge // self.dc


def code_from_checks(chk_to_var: jax.Array, n: int, dv: int, dc: int) -> LDPCCode:
    """Build an :class:`LDPCCode` from a check->variable socket table.

    ``var_to_edge`` is derived with a stable argsort of the flattened
    check->variable table: the sorted order groups the dv sockets of each
    variable contiguously, ascending by edge id -- the same ordering the
    reference builds imperatively (random_code_generator.c:53-63).

    Works under ``jit``/``vmap`` (shapes are static in n, dv, dc).
    """
    chk_to_var = jnp.asarray(chk_to_var, jnp.int32).reshape(
        (n * dv) // dc, dc
    )
    flat = chk_to_var.reshape(-1)
    order = jnp.argsort(flat, stable=True).astype(jnp.int32)
    # Re-attach flat's varying-manual-axes type: jax 0.9.0's argsort index
    # output drops the operand's vma under shard_map (see
    # models/ensemble._with_key_vma); the zero-add is folded by XLA.
    order = order + (flat[0] & jnp.int32(0))
    var_to_edge = order.reshape(n, dv)
    return LDPCCode(chk_to_var=chk_to_var, var_to_edge=var_to_edge, n=n, dv=dv, dc=dc)


def dense_parity_check(code: LDPCCode) -> np.ndarray:
    """Dense boolean H of shape [m, n] (small-n export / oracle use only).

    Equivalent of the bitmap the reference builds per trial
    (random_code_generator.c:53-56, parallel_simulator.py:203).
    """
    chk_to_var = np.asarray(code.chk_to_var)
    h = np.zeros((code.m, code.n), dtype=bool)
    rows = np.repeat(np.arange(code.m), code.dc)
    h[rows, chk_to_var.reshape(-1)] = True
    return h


def code_from_dense(h: np.ndarray) -> LDPCCode:
    """Inverse of :func:`dense_parity_check` for regular H (tools interop)."""
    h = np.asarray(h, dtype=bool)
    m, n = h.shape
    dc = int(h[0].sum())
    dv = int(h[:, 0].sum())
    if not ((h.sum(axis=1) == dc).all() and (h.sum(axis=0) == dv).all()):
        raise ValueError("parity-check matrix is not (dv,dc)-regular")
    chk_to_var = np.nonzero(h)[1].reshape(m, dc).astype(np.int32)
    return code_from_checks(jnp.asarray(chk_to_var), n=n, dv=dv, dc=dc)


def validate_code(code: LDPCCode) -> Tuple[bool, str]:
    """Host-side structural validation (tools/code_checker.py equivalent)."""
    chk_to_var = np.asarray(code.chk_to_var)
    m, dc = chk_to_var.shape
    if m != code.m or dc != code.dc:
        return False, "shape mismatch"
    if chk_to_var.min() < 0 or chk_to_var.max() >= code.n:
        return False, "variable index out of range"
    counts = np.bincount(chk_to_var.reshape(-1), minlength=code.n)
    if not (counts == code.dv).all():
        return False, "variable degrees are not all dv"
    for row in chk_to_var:
        if len(set(row.tolist())) != dc:
            return False, "check touches the same variable twice"
    var_to_edge = np.asarray(code.var_to_edge)
    if not (chk_to_var.reshape(-1)[var_to_edge]
            == np.arange(code.n)[:, None]).all():
        return False, "var_to_edge inconsistent with chk_to_var"
    return True, "ok"
