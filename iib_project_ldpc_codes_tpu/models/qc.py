"""Quasi-cyclic (protograph-lifted) LDPC codes.

Beyond-reference extension motivated by a structural limit: at huge n
the random-ensemble packed decoder's gathers have no locality (random
Tanner graphs are expanders, so no relabeling can give them any).
Production LDPC (5G NR, 802.11, DVB-S2) solves this
structurally: the parity-check matrix is a BASE graph whose edges are
Z x Z circulant permutations.  That structure turns every per-edge
"gather" into a ``jnp.roll`` of a contiguous [Z, W] plane, i.e. a
stream copy, at ANY block length.

Container: a (dvb,dcb)-regular base graph in the same edge-list form as
:class:`..models.code.LDPCCode` (sampled by the existing configuration-
model sampler at base scale), plus an int shift per base edge.  The
lifted code has n = nb * Z variables; check (c, z) of base check c
connects variable (j, (z + s_cj) mod Z) for each base socket j -- the
standard circulant convention.

``expand()`` materialises the lifted code as a plain :class:`LDPCCode`,
so EVERY existing kernel, driver, and analysis runs on QC codes
unchanged (and serves as the bit-exactness oracle for the roll-based
decoder, ops/qc_bp.py).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from .code import LDPCCode, code_from_checks
from .ensemble import sample_check_table


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class QCLDPCCode:
    """A Z-lifted (dvb,dcb)-regular protograph code.

    ``base_chk[mb, dcb]`` -- base-variable index per base-check socket
    (a base-scale ``chk_to_var`` table); ``shifts[mb, dcb]`` -- the
    circulant shift of each base edge, in [0, Z).
    """

    base_chk: jax.Array   # int32[mb, dcb]
    shifts: jax.Array     # int32[mb, dcb]
    Z: int = dataclasses.field(metadata=dict(static=True))
    nb: int = dataclasses.field(metadata=dict(static=True))
    dv: int = dataclasses.field(metadata=dict(static=True))
    dc: int = dataclasses.field(metadata=dict(static=True))

    @property
    def mb(self) -> int:
        return (self.nb * self.dv) // self.dc

    @property
    def n(self) -> int:
        return self.nb * self.Z

    @property
    def m(self) -> int:
        return self.mb * self.Z

    @property
    def k(self) -> int:
        return self.n * (self.dc - self.dv) // self.dc

    def expand(self) -> LDPCCode:
        """Materialise the lifted code as a generic edge-list code.

        Lifted variable (j, z) gets index j*Z + z; lifted check (c, z)
        gets index c*Z + z and its socket for base socket (c, jj) is
        variable (base_chk[c, jj], (z + shifts[c, jj]) mod Z).
        """
        base = np.asarray(self.base_chk)
        sh = np.asarray(self.shifts)
        mb, dcb = base.shape
        z = np.arange(self.Z)
        # [mb, Z, dcb]
        var = (base[:, None, :] * self.Z
               + (z[None, :, None] + sh[:, None, :]) % self.Z)
        chk = var.reshape(mb * self.Z, dcb).astype(np.int32)
        return code_from_checks(jnp.asarray(chk), n=self.n, dv=self.dv,
                                dc=self.dc)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class IrregularQCLDPCCode:
    """A Z-lifted IRREGULAR protograph code (5G-NR-style base graphs).

    ``base_chk[mb, dcb_max]`` -- base-variable index per base-check
    socket, padded with the sentinel ``nb`` (absent socket);
    ``shifts`` -- circulant shift per base edge (0 at padding).  The
    roll decoders need no phantom machinery for irregularity: padded
    sockets are simply filtered out of the static adjacency, so every
    lifted check/variable runs at its real degree.
    """

    base_chk: jax.Array   # int32[mb, dcb_max], sentinel nb
    shifts: jax.Array     # int32[mb, dcb_max]
    Z: int = dataclasses.field(metadata=dict(static=True))
    nb: int = dataclasses.field(metadata=dict(static=True))
    mb: int = dataclasses.field(metadata=dict(static=True))

    @property
    def n(self) -> int:
        return self.nb * self.Z

    @property
    def m(self) -> int:
        return self.mb * self.Z

    @property
    def k(self) -> int:
        return self.n - self.m

    def expand(self):
        """Materialise as a phantom-padded
        :class:`..models.irregular.IrregularLDPCCode` (so every generic
        irregular kernel/driver runs on the lifted code), built
        directly from the lift structure -- no dense H, so this works
        at any n.
        """
        from .irregular import IrregularLDPCCode

        base = np.asarray(self.base_chk)
        sh = np.asarray(self.shifts)
        mb, dcb_max = base.shape
        Z, nb = self.Z, self.nb
        n, m = self.n, self.m
        z = np.arange(Z)

        chk_to_var = np.full((m + 1, dcb_max), n, np.int32)
        for c in range(mb):
            real = np.nonzero(base[c] < nb)[0]
            for slot, j in enumerate(real):
                chk_to_var[c * Z:(c + 1) * Z, slot] = (
                    base[c, j] * Z + (z + sh[c, j]) % Z)

        # variable side: block b's base sockets in (check, slot, shift)
        # form; lifted variable (b, z) meets check (c, (z - s) mod Z)
        var_sockets = [[] for _ in range(nb)]
        for c in range(mb):
            real = np.nonzero(base[c] < nb)[0]
            for slot, j in enumerate(real):
                var_sockets[int(base[c, j])].append((c, slot, int(sh[c, j])))
        dv_max = max(len(s) for s in var_sockets)
        var_to_chk = np.full((n + 1, dv_max), m, np.int32)
        var_to_sock = np.full((n + 1, dv_max), m * dcb_max, np.int32)
        for b, sockets in enumerate(var_sockets):
            for i, (c, slot, s) in enumerate(sockets):
                rows = c * Z + (z - s) % Z
                var_to_chk[b * Z:(b + 1) * Z, i] = rows
                var_to_sock[b * Z:(b + 1) * Z, i] = rows * dcb_max + slot
        E = sum(len(s) for s in var_sockets) * Z
        return IrregularLDPCCode(
            chk_to_var=jnp.asarray(chk_to_var),
            var_to_chk=jnp.asarray(var_to_chk),
            var_to_sock=jnp.asarray(var_to_sock),
            n=n, m=m, dv_max=dv_max, dc_max=dcb_max, num_edges=E)


def sample_qc_code_irregular(key: jax.Array, nb: int, lam, rho, Z: int,
                             method: str = "repair"
                             ) -> IrregularQCLDPCCode:
    """Sample an irregular protograph: base graph from the (lam, rho)
    configuration model at base scale nb (models/irregular.py sampler),
    shifts uniform in [0, Z) on the real sockets."""
    from .irregular import IrregularEnsembleSpec

    k_base, k_shift = jax.random.split(key)
    spec = IrregularEnsembleSpec.from_lam_rho(nb, lam, rho)
    base = spec.sample(k_base, method)
    base_chk = jnp.asarray(np.asarray(base.chk_to_var)[:-1])  # drop
    # the phantom row; sentinel entries == nb mark absent sockets
    shifts = jax.random.randint(k_shift, base_chk.shape, 0, Z, jnp.int32)
    shifts = jnp.where(base_chk < nb, shifts, 0)
    return IrregularQCLDPCCode(base_chk=base_chk, shifts=shifts, Z=Z,
                               nb=nb, mb=int(base.m))


def sample_qc_code(key: jax.Array, nb: int, dv: int, dc: int, Z: int,
                   method: str = "repair") -> QCLDPCCode:
    """Sample a QC code: base graph from the (dv,dc) configuration model
    (simple: no repeated variable within a base check -- which also
    guarantees the lifted code is simple for any shifts), shifts uniform
    in [0, Z).  Keyed and reproducible like every sampler here.
    """
    if (nb * dv) % dc:
        raise ValueError("nb*dv must be divisible by dc")
    k_base, k_shift = jax.random.split(key)
    base = sample_check_table(k_base, nb, dv, dc, method)
    shifts = jax.random.randint(k_shift, base.shape, 0, Z, jnp.int32)
    return QCLDPCCode(base_chk=base, shifts=shifts, Z=Z, nb=nb,
                      dv=dv, dc=dc)


def design_protograph(key: jax.Array, nb: int, lam, rho, Z: int,
                      tries: int = 32, method: str = "repair"):
    """Pick the best of ``tries`` sampled irregular bases by their
    P-EXIT threshold (utils.theory.protograph_threshold -- the exact
    Z->infinity lift threshold), then attach shifts.

    Small random protographs scatter well below the (lam, rho)
    ensemble threshold (round-5 measured law: a random nb=24 base sits
    at 0.449 vs the ensemble's 0.4526); this rejection design recovers
    most of the gap at protograph scale, the same workflow standards
    use (their bases are hand-optimised).  Returns
    ``(IrregularQCLDPCCode, threshold)``.
    """
    from ..utils.theory import protograph_threshold
    from .irregular import IrregularEnsembleSpec

    spec = IrregularEnsembleSpec.from_lam_rho(nb, lam, rho)
    k_design, k_shift = jax.random.split(key)
    best, best_t = None, -1.0
    for k in jax.random.split(k_design, tries):
        base = spec.sample(k, method)
        base_chk = np.asarray(base.chk_to_var)[:-1]
        t = protograph_threshold(base_chk, nb, precision=1e-4)
        if t > best_t:
            best, best_t = base_chk, t
    shifts = jax.random.randint(k_shift, best.shape, 0, Z, jnp.int32)
    shifts = jnp.where(jnp.asarray(best) < nb, shifts, 0)
    code = IrregularQCLDPCCode(base_chk=jnp.asarray(best), shifts=shifts,
                               Z=Z, nb=nb, mb=int(best.shape[0]))
    return code, best_t
