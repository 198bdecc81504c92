"""Irregular (lambda, rho) LDPC ensembles: container + configuration-model
sampler.

Capability extension of the reference's regular-only sampler
(random_code_generator.c:21-67) to arbitrary per-node degree sequences --
the flagship irregular extension whose analysis side lives in
utils/theory.py (irregular_density_evolution / irregular_threshold).

Padding design ("phantom nodes", no masks in the hot loop):

  * Check rows are padded to ``dc_max`` with a **phantom variable** at
    index ``n``.  The packed decoder keeps its state planes as
    ``[n+1, W]`` with row ``n`` permanently *known* with value 0, so a
    phantom socket never blocks extrinsic validity, contributes nothing
    to the parity XOR, and is never "the unique unknown".
  * Variable rows are padded to ``dv_max`` with a **phantom check** at
    index ``m`` whose socket row is all-phantom-variable; all its
    participants are known, so its exactly-one-unknown summary is
    identically zero and padded variable sockets gather nothing.

With those two rows in place the *regular* bit-packed BP iteration
(ops/erasure_bp._packed_iteration) runs verbatim on irregular codes --
same per-socket contiguous-plane gathers, no select/mask ops -- at an
overhead equal to the padding fraction only.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .ensemble import _with_key_vma, match_until_simple


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class IrregularLDPCCode:
    """An irregular LDPC code in phantom-padded edge-list form.

    ``chk_to_var[m+1, dc_max]``: variable index per check socket, padded
    with ``n`` (the phantom variable); row ``m`` is the all-phantom
    phantom check.  ``var_to_chk[n+1, dv_max]``: check index per variable
    socket, padded with ``m``; row ``n`` is the phantom variable's.
    ``var_to_sock[n+1, dv_max]``: flat position of each variable socket in
    the padded ``[m+1, dc_max]`` check-socket grid (the irregular
    analogue of the regular container's ``var_to_edge``), padding -> a
    phantom-row position.
    """

    chk_to_var: jax.Array   # int32[m+1, dc_max]
    var_to_chk: jax.Array   # int32[n+1, dv_max]
    var_to_sock: jax.Array  # int32[n+1, dv_max]
    n: int = dataclasses.field(metadata=dict(static=True))
    m: int = dataclasses.field(metadata=dict(static=True))
    dv_max: int = dataclasses.field(metadata=dict(static=True))
    dc_max: int = dataclasses.field(metadata=dict(static=True))
    num_edges: int = dataclasses.field(metadata=dict(static=True))

    @property
    def k(self) -> int:
        return self.n - self.m

    @property
    def rate(self) -> float:
        return self.k / self.n

    @property
    def chk_mask(self) -> jax.Array:
        """bool[m+1, dc_max]: real (non-phantom) check sockets."""
        return self.chk_to_var < self.n

    @property
    def var_mask(self) -> jax.Array:
        """bool[n+1, dv_max]: real (non-phantom) variable sockets."""
        return self.var_to_chk < self.m

    @property
    def chk_degrees(self) -> jax.Array:
        """int32[m]: real check degrees."""
        return jnp.sum(self.chk_mask[:-1], axis=1).astype(jnp.int32)

    @property
    def var_degrees(self) -> jax.Array:
        """int32[n]: real variable degrees."""
        return jnp.sum(self.var_mask[:-1], axis=1).astype(jnp.int32)


# ---------------------------------------------------------------------------
# Degree sequences from (lambda, rho)
# ---------------------------------------------------------------------------

def _largest_remainder(fracs: np.ndarray, total: int) -> np.ndarray:
    """Integer counts summing to ``total`` proportional to ``fracs``."""
    raw = fracs * total
    counts = np.floor(raw).astype(np.int64)
    short = total - int(counts.sum())
    if short > 0:
        order = np.argsort(-(raw - counts))
        counts[order[:short]] += 1
    return counts


def degree_sequences_from_lam_rho(n: int, lam: Sequence[float],
                                  rho: Sequence[float]
                                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Finite-n node-degree sequences realising edge-perspective
    (lambda, rho) as closely as integer rounding allows.

    Coefficient convention matches utils/theory.py: ``lam[i]`` is the
    fraction of edges attached to degree-(i+1) variable nodes.  Node
    fractions are L_d = (lam_d/d) / sum_j (lam_j/j); variable counts are
    rounded by largest remainder to sum n, the resulting edge total E
    fixes the check side, whose rounding residue is absorbed by bumping
    the degrees of the largest-remainder checks by +-1 (the standard
    finite-length construction; the ensemble's (lambda, rho) converges to
    the target as n grows).
    """
    lam = np.asarray(lam, float)
    rho = np.asarray(rho, float)
    if lam[0] != 0 or rho[0] != 0:
        raise ValueError("lam/rho must have zero degree-1 mass (c0 == 0)")
    degs_v = np.arange(1, lam.size + 1)
    node_frac_v = np.where(lam > 0, lam / degs_v, 0.0)
    node_frac_v /= node_frac_v.sum()
    counts_v = _largest_remainder(node_frac_v, n)
    var_degrees = np.repeat(degs_v, counts_v)
    E = int(var_degrees.sum())

    degs_c = np.arange(1, rho.size + 1)
    node_frac_c = np.where(rho > 0, rho / degs_c, 0.0)
    inv_avg_c = node_frac_c.sum()          # = int(rho) = 1/avg check degree
    node_frac_c /= inv_avg_c
    m = max(int(round(E * inv_avg_c)), 1)
    counts_c = _largest_remainder(node_frac_c, m)
    chk_degrees = np.repeat(degs_c, counts_c).astype(np.int64)
    # absorb the edge-rounding residue by +-1 bumps spread over checks
    diff = E - int(chk_degrees.sum())
    step = 1 if diff > 0 else -1
    i = 0
    order = np.argsort(chk_degrees) if step > 0 else np.argsort(-chk_degrees)
    diff_at_sweep_start = diff
    while diff != 0:
        # a full sweep of m candidates without progress means the residue
        # is unabsorbable (every check already at degree 1 while diff < 0)
        # -- fail loudly instead of spinning (e.g. rho so light that
        # E < m, which no valid degree sequence can realise)
        if i and i % m == 0:
            if diff == diff_at_sweep_start:
                raise ValueError(
                    f"cannot absorb edge residue {diff} into {m} checks "
                    "(degree floor 1); (lam, rho) is unrealisable at "
                    f"this n")
            diff_at_sweep_start = diff
        c = order[i % m]
        nd = chk_degrees[c] + step
        if 1 <= nd:
            chk_degrees[c] = nd
            diff -= step
        i += 1
    return var_degrees.astype(np.int64), chk_degrees


# ---------------------------------------------------------------------------
# Ensemble spec: static socket maps + jitted sampler
# ---------------------------------------------------------------------------

class IrregularEnsembleSpec:
    """Host-side description of one irregular ensemble.

    Precomputes the static socket maps the on-device sampler needs
    (everything that depends only on the degree *sequences*, not the
    random matching).  Build once, sample many (``sample`` /
    ``sample_batch`` are jitted; the maps are device constants).
    """

    def __init__(self, var_degrees, chk_degrees):
        var_degrees = np.asarray(var_degrees, np.int64)
        chk_degrees = np.asarray(chk_degrees, np.int64)
        if var_degrees.min() < 1 or chk_degrees.min() < 1:
            raise ValueError("all node degrees must be >= 1")
        if var_degrees.sum() != chk_degrees.sum():
            raise ValueError("variable and check socket counts differ")
        self.var_degrees = var_degrees
        self.chk_degrees = chk_degrees
        self.n = int(var_degrees.size)
        self.m = int(chk_degrees.size)
        self.E = int(var_degrees.sum())
        self.dv_max = int(var_degrees.max())
        self.dc_max = int(chk_degrees.max())

        n, m, E = self.n, self.m, self.E
        # socket ownership maps (configuration model)
        socket_var = np.repeat(np.arange(n), var_degrees)       # [E]
        chk_of_socket = np.repeat(np.arange(m), chk_degrees)    # [E]
        # padded check-socket grid [(m+1), dc_max] -> socket index or E
        pad_map = np.full((m + 1, self.dc_max), E, np.int64)
        offs = np.concatenate([[0], np.cumsum(chk_degrees)])
        for c in range(m):
            d = int(chk_degrees[c])
            pad_map[c, :d] = np.arange(offs[c], offs[c] + d)
        # inverse: socket index -> flat padded position
        sock_to_pad = np.zeros(E, np.int64)
        flat = pad_map.reshape(-1)
        sock_to_pad[flat[flat < E]] = np.nonzero(flat < E)[0]
        # padded variable-socket grid [(n+1), dv_max] -> var socket or E
        var_pad_map = np.full((n + 1, self.dv_max), E, np.int64)
        voffs = np.concatenate([[0], np.cumsum(var_degrees)])
        for v in range(n):
            d = int(var_degrees[v])
            var_pad_map[v, :d] = np.arange(voffs[v], voffs[v] + d)

        as_i32 = lambda a: jnp.asarray(a, jnp.int32)
        self._socket_var = as_i32(socket_var)
        self._chk_of_socket = as_i32(chk_of_socket)
        self._pad_map = as_i32(pad_map)
        self._sock_to_pad = as_i32(sock_to_pad)
        self._var_pad_map = as_i32(var_pad_map)

    @classmethod
    def from_lam_rho(cls, n: int, lam, rho) -> "IrregularEnsembleSpec":
        return cls(*degree_sequences_from_lam_rho(n, lam, rho))

    @classmethod
    def regular(cls, n: int, dv: int, dc: int) -> "IrregularEnsembleSpec":
        """Degenerate spec of the (dv,dc)-regular ensemble (oracle use)."""
        if (n * dv) % dc:
            raise ValueError("n*dv must be divisible by dc")
        return cls(np.full(n, dv), np.full((n * dv) // dc, dc))

    # -- sampling ----------------------------------------------------------

    def sample(self, key: jax.Array, method: str = "repair"
               ) -> IrregularLDPCCode:
        """Sample one simple code (no check touches a variable twice)."""
        chk_to_var, var_to_chk, var_to_sock = _sample_irregular(
            key, self._socket_var, self._chk_of_socket, self._pad_map,
            self._sock_to_pad, self._var_pad_map, self.n, self.m,
            method)
        return IrregularLDPCCode(
            chk_to_var=chk_to_var, var_to_chk=var_to_chk,
            var_to_sock=var_to_sock, n=self.n, m=self.m,
            dv_max=self.dv_max, dc_max=self.dc_max, num_edges=self.E)

    def sample_batch(self, key: jax.Array, num: int,
                     method: str = "repair") -> IrregularLDPCCode:
        """Batch of codes; arrays gain a leading [num] axis (vmap-ready)."""
        keys = jax.random.split(key, num)
        return jax.vmap(lambda k: self.sample(k, method))(keys)


def _row_duplicates(chk_to_var: jax.Array, n: int) -> jax.Array:
    """bool[m+1, dc_max]: socket j repeats an earlier *real* socket of its
    row (phantom entries == n never count)."""
    eq = chk_to_var[:, :, None] == chk_to_var[:, None, :]
    dc_max = chk_to_var.shape[1]
    tri = jnp.tril(jnp.ones((dc_max, dc_max), bool), k=-1)
    return jnp.any(eq & tri, axis=2) & (chk_to_var < n)


@partial(jax.jit, static_argnames=("n", "m", "method"))
def _sample_irregular(key, socket_var, chk_of_socket, pad_map, sock_to_pad,
                      var_pad_map, n: int, m: int, method: str):
    """Configuration-model matching with the reference's simplicity rule.

    Assign variable sockets to check sockets by a uniform permutation of
    the E socket sequence (the irregular generalisation of
    random_code_generator.c:32-36), then either resample wholly
    ("reject", the reference's rule :39-47) or swap duplicated sockets
    with uniform partners ("repair") until every check row is simple.
    """
    E = socket_var.shape[0]
    # gather tables padded with one sentinel slot so clip-free phantom
    # lookups land on the phantom ids
    socket_var_ext = jnp.concatenate(
        [socket_var, jnp.full((1,), n, jnp.int32)])
    chk_of_socket_ext = jnp.concatenate(
        [chk_of_socket, jnp.full((1,), m, jnp.int32)])

    def checks_of(perm):
        # perm[s] = variable socket matched to check socket s
        perm_ext = jnp.concatenate([perm.astype(jnp.int32),
                                    jnp.full((1,), E, jnp.int32)])
        return socket_var_ext[perm_ext[pad_map]]   # [m+1, dc_max]

    def draw_perm(sub):
        return _with_key_vma(jax.random.permutation(sub, E), sub)

    def dup_info(perm):
        dup = _row_duplicates(checks_of(perm), n)
        # first duplicated padded position -> its check socket index
        p = jnp.argmax(dup.reshape(-1)).astype(jnp.int32)
        return jnp.any(dup), pad_map.reshape(-1)[p]  # dup => socket < E

    perm = match_until_simple(key, E, draw_perm, dup_info, method)

    chk_to_var = checks_of(perm)
    # variable side: var socket t matches check socket inv[t]
    inv = jnp.argsort(perm).astype(jnp.int32)
    inv = inv + (perm[0].astype(jnp.int32) & jnp.int32(0))  # vma re-tag
    inv_ext = jnp.concatenate([inv, jnp.full((1,), E, jnp.int32)])
    # padding sentinel = the phantom row's first flat grid position
    # (row m, socket 0), honouring the class invariant that padded
    # var_to_sock entries land on the phantom check row
    dc_max = pad_map.shape[1]
    sock_to_pad_ext = jnp.concatenate(
        [sock_to_pad, jnp.full((1,), m * dc_max, jnp.int32)])
    var_to_chk = chk_of_socket_ext[inv_ext[var_pad_map]]     # [n+1, dv_max]
    var_to_sock = sock_to_pad_ext[inv_ext[var_pad_map]]      # [n+1, dv_max]
    return chk_to_var, var_to_chk, var_to_sock


# ---------------------------------------------------------------------------
# Dense interop + validation (small-n oracle use)
# ---------------------------------------------------------------------------

def dense_parity_check_irregular(code: IrregularLDPCCode) -> np.ndarray:
    """Dense boolean H of shape [m, n]."""
    chk = np.asarray(code.chk_to_var)[:-1]           # drop phantom row
    h = np.zeros((code.m, code.n), bool)
    for c in range(code.m):
        for v in chk[c]:
            if v < code.n:
                h[c, v] = True
    return h


def irregular_code_from_dense(h: np.ndarray) -> IrregularLDPCCode:
    """Build the phantom-padded container from a dense H (tools interop)."""
    h = np.asarray(h, bool)
    m, n = h.shape
    chk_degrees = h.sum(axis=1).astype(np.int64)
    var_degrees = h.sum(axis=0).astype(np.int64)
    dc_max = int(chk_degrees.max())
    dv_max = int(var_degrees.max())
    E = int(h.sum())
    chk_to_var = np.full((m + 1, dc_max), n, np.int32)
    # socket index grid aligned with IrregularEnsembleSpec's pad_map
    offs = np.concatenate([[0], np.cumsum(chk_degrees)])
    pad_pos = np.full((m + 1, dc_max), -1, np.int64)
    for c in range(m):
        vs = np.nonzero(h[c])[0]
        chk_to_var[c, : vs.size] = vs
        pad_pos[c, : vs.size] = np.arange(vs.size) + offs[c]
    var_to_chk = np.full((n + 1, dv_max), m, np.int32)
    # padding -> the phantom row's first flat grid position (row m)
    var_to_sock = np.full((n + 1, dv_max), m * dc_max, np.int32)
    fill = np.zeros(n, np.int64)
    for c in range(m):
        for j in range(int(chk_degrees[c])):
            v = chk_to_var[c, j]
            var_to_chk[v, fill[v]] = c
            var_to_sock[v, fill[v]] = c * dc_max + j
            fill[v] += 1
    return IrregularLDPCCode(
        chk_to_var=jnp.asarray(chk_to_var), var_to_chk=jnp.asarray(var_to_chk),
        var_to_sock=jnp.asarray(var_to_sock), n=n, m=m,
        dv_max=dv_max, dc_max=dc_max, num_edges=E)


def validate_irregular_code(code: IrregularLDPCCode,
                            spec: IrregularEnsembleSpec = None
                            ) -> Tuple[bool, str]:
    """Host-side structural validation (code_checker analogue)."""
    chk = np.asarray(code.chk_to_var)
    var = np.asarray(code.var_to_chk)
    sock = np.asarray(code.var_to_sock)
    n, m = code.n, code.m
    if chk.shape != (m + 1, code.dc_max) or var.shape != (n + 1, code.dv_max):
        return False, "shape mismatch"
    if not (chk[-1] == n).all():
        return False, "phantom check row must be all-phantom"
    if not (var[-1] == m).all():
        return False, "phantom variable row must point at the phantom check"
    real = chk[:-1][chk[:-1] < n]
    if real.size != code.num_edges:
        return False, "edge count mismatch"
    # simplicity: no duplicate real variable within a check row
    for c in range(m):
        row = chk[c][chk[c] < n]
        if len(set(row.tolist())) != row.size:
            return False, f"check {c} touches a variable twice"
    # padding must be trailing (spec pad_map layout)
    if spec is not None:
        if not (np.sort(np.asarray(spec.chk_degrees))
                == np.sort((chk[:-1] < n).sum(1))).all():
            return False, "check degree multiset mismatch"
        if not (np.sort(np.asarray(spec.var_degrees))
                == np.sort(np.bincount(real, minlength=n))).all():
            return False, "variable degree multiset mismatch"
    # var tables consistent: the socket position holds this variable;
    # padded entries land on the phantom check row
    flat = chk.reshape(-1)
    for v in range(n):
        for j in range(code.dv_max):
            if var[v, j] < m:
                if flat[sock[v, j]] != v:
                    return False, "var_to_sock inconsistent"
                if sock[v, j] // code.dc_max != var[v, j]:
                    return False, "var_to_chk inconsistent"
            elif sock[v, j] // code.dc_max != m:
                return False, "padded var_to_sock not on the phantom row"
    counts = np.bincount(real, minlength=n)
    if not (counts == (var[:-1] < m).sum(1)).all():
        return False, "variable degrees inconsistent between tables"
    return True, "ok"
