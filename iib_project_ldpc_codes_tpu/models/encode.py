"""Systematic encoding for LDPC codes.

The reference's ``encode`` is vestigial: its generator-matrix construction
is commented out (simulator.py:53, parallel_simulator.py:47) and every
simulation transmits the all-zero codeword.  Here the capability is real:
a systematic generator is derived from H by bit-packed GF(2) elimination
(reusing the ML decoder's kernel), supporting rank-deficient H (random
configuration-model matrices lose a few ranks with positive probability).

Layout: pivot columns of H carry parity bits, free columns carry the
``k_eff = n - rank(H)`` information bits.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..ops.ml import _WORD, _pack_rows, gf2_row_reduce
from .code import LDPCCode, dense_parity_check


@dataclasses.dataclass(frozen=True)
class Encoder:
    """Systematic encoder for one code."""

    n: int
    pivot_cols: np.ndarray        # int[rank]: parity positions
    free_cols: np.ndarray         # int[k_eff]: information positions
    # parity_map[r] = packed row over free columns: parity bit r is the
    # XOR of the info bits selected by this row
    parity_map: np.ndarray        # uint64[rank, words]

    @property
    def k_eff(self) -> int:
        return len(self.free_cols)

    @property
    def rank(self) -> int:
        return len(self.pivot_cols)

    def encode(self, info_bits: np.ndarray) -> np.ndarray:
        """info_bits [..., k_eff] -> codewords [..., n] over GF(2)."""
        info_bits = np.asarray(info_bits, np.uint8) & 1
        if info_bits.shape[-1] != self.k_eff:
            raise ValueError(
                f"need {self.k_eff} information bits, got "
                f"{info_bits.shape[-1]}")
        flat = info_bits.reshape(-1, self.k_eff)
        words = self.parity_map.shape[1]
        packed = np.zeros((flat.shape[0], words), np.uint64)
        for j in range(self.k_eff):
            packed[:, j // _WORD] |= (flat[:, j].astype(np.uint64)
                                      << np.uint64(j % _WORD))
        out = np.zeros((flat.shape[0], self.n), np.uint8)
        out[:, self.free_cols] = flat
        for r, col in enumerate(self.pivot_cols):
            acc = packed & self.parity_map[r]
            bits = np.zeros(flat.shape[0], np.uint64)
            for w in range(words):
                bits ^= acc[:, w]
            # parity of the word popcounts
            parity = np.zeros(flat.shape[0], np.uint8)
            v = bits
            while v.any():
                parity ^= (v & np.uint64(1)).astype(np.uint8)
                v = v >> np.uint64(1)
            out[:, col] = parity
        return out.reshape(info_bits.shape[:-1] + (self.n,))


def encoder_planes(enc: Encoder):
    """Device constants for :func:`encode_packed`: (mask, free, pivots).

    ``mask`` is bool[rank, k_eff] (parity bit r = XOR of the selected
    info bits), unpacked from the host encoder's uint64 rows once.

    The dense mask is O(n^2) host memory plus a device transfer
    (rank * k_eff ~ n^2/4 bools): random-codeword transmit is a
    validation-scale feature.  Guarded at 256 MB (~n = 3e4) with a clear
    error instead of an OOM deep in the chunk build.
    """
    import jax.numpy as jnp

    mask = _unpack_parity_mask(enc)
    return (jnp.asarray(mask), jnp.asarray(enc.free_cols, jnp.int32),
            jnp.asarray(enc.pivot_cols, jnp.int32))


def _unpack_parity_mask(enc: Encoder) -> np.ndarray:
    """Host-side dense bool[rank, k_eff] of the packed parity map,
    shared by the single-code and padded-batch plane builders (no
    device round-trip)."""
    rank, k_eff = enc.rank, enc.k_eff
    if rank * k_eff > 2 ** 28:
        raise ValueError(
            f"encoder_planes would materialise a {rank}x{k_eff} dense "
            "GF(2) map (> 256 MB): transmit='random' is a validation-"
            "scale feature (n up to ~3e4); use the all-zero transmit at "
            "larger block lengths")
    mask = np.zeros((rank, k_eff), bool)
    for j in range(k_eff):
        mask[:, j] = (enc.parity_map[:, j // _WORD]
                      >> np.uint64(j % _WORD)) & np.uint64(1) != 0
    return mask


def encode_packed(planes, info: "jax.Array", n: int | None = None
                  ) -> "jax.Array":
    """Encode 32*W codewords on device from packed information planes.

    ``planes`` from :func:`encoder_planes` (or the padded batch form,
    :func:`encoder_planes_padded`); ``info`` is uint32[k_eff, W] (bit
    lane b of word w = information word of trial 32w+b).  Returns
    uint32[n, W] packed codewords.  GF(2) parity accumulation is a
    ``lax.scan`` over info rows (memory-light: [rank, W] carry), jittable
    and vmap-able -- the device realisation of the reference's missing
    ``coding_matrix`` encode (simulator.py:61-64) for nonzero-codeword
    Monte Carlo (SimulationConfig.transmit="random").

    ``n`` must be given for padded planes (sentinel column indices == n
    are dropped by the scatters); the unpadded default infers it.
    """
    import jax
    import jax.numpy as jnp

    mask, free, pivots = planes
    rank, k_eff = mask.shape
    if n is None:
        n = len(free) + len(pivots)
    info = jnp.asarray(info, jnp.uint32)
    w = info.shape[1]

    def step(acc, row_j):
        m_j, bits_j = row_j           # bool[rank], uint32[W]
        return acc ^ (jnp.where(m_j, jnp.uint32(0xFFFFFFFF),
                                jnp.uint32(0))[:, None] & bits_j[None, :]), None

    parity, _ = jax.lax.scan(step, jnp.zeros((rank, w), jnp.uint32),
                             (mask.T, info))
    out = jnp.zeros((n, w), jnp.uint32)
    out = out.at[free].set(info, mode="drop")
    out = out.at[pivots].set(parity, mode="drop")
    return out


def encoder_planes_padded(encoders, n: int):
    """Stacked device planes for a *batch* of encoders (one per fresh
    ensemble code): masks/index vectors are padded to common static
    widths so the batch jits and vmaps (ragged ``rank``/``k_eff`` vary
    by the sampled H's rank deficiency).  Padded index entries are the
    sentinel ``n`` -- dropped by :func:`encode_packed`'s out-of-bounds
    scatters; padded mask columns are zero (the extra info bits encode
    nothing and land nowhere).

    Returns (mask bool[C, rank_max, k_max], free int32[C, k_max],
    pivots int32[C, rank_max]).
    """
    import jax.numpy as jnp

    rank_max = max(e.rank for e in encoders)
    k_max = max(e.k_eff for e in encoders)
    masks = np.zeros((len(encoders), rank_max, k_max), bool)
    frees = np.full((len(encoders), k_max), n, np.int32)
    pivs = np.full((len(encoders), rank_max), n, np.int32)
    for i, enc in enumerate(encoders):
        # build host-side and upload ONCE (going through encoder_planes
        # here would bounce each O(n^2/4) mask device->host before
        # re-uploading the stack)
        masks[i, :enc.rank, :enc.k_eff] = _unpack_parity_mask(enc)
        frees[i, :enc.k_eff] = enc.free_cols
        pivs[i, :enc.rank] = enc.pivot_cols
    return jnp.asarray(masks), jnp.asarray(frees), jnp.asarray(pivs)


def make_encoder(code: Optional[LDPCCode] = None,
                 h: Optional[np.ndarray] = None) -> Encoder:
    """Derive the systematic encoder from H (the reference's missing
    ``coding_matrix``).  Pass ``h`` directly for non-regular containers
    (e.g. ``models.irregular.dense_parity_check_irregular`` output)."""
    if h is None:
        if code is None:
            raise ValueError("need a code or a dense H")
        h = dense_parity_check(code)
    h = np.asarray(h, bool)
    m, n = h.shape
    packed = _pack_rows(h)
    packed, pivots = gf2_row_reduce(packed, n)
    pivots = np.asarray(pivots, int)
    free = np.setdiff1d(np.arange(n), pivots)
    # After Gauss-Jordan, row r reads: x[pivot[r]] + sum_{f in free}
    # R[r, f] x[f] = 0  =>  parity = XOR of selected info bits.
    words = (len(free) + _WORD - 1) // _WORD
    parity_map = np.zeros((len(pivots), words), np.uint64)
    for r in range(len(pivots)):
        for jf, f in enumerate(free):
            bit = (packed[r, f // _WORD] >> np.uint64(f % _WORD)) & np.uint64(1)
            if bit:
                parity_map[r, jf // _WORD] |= np.uint64(1) << np.uint64(
                    jf % _WORD)
    return Encoder(n=n, pivot_cols=pivots, free_cols=free,
                   parity_map=parity_map)
