"""Edge-sharded erasure BP for huge block lengths (n ~ 10^6).

BASELINE.json config 5 asks for "n=10^6 edge-sharded BP across a multi-host
pod".  The analogue of sequence parallelism here is the code-length axis
(SURVEY.md section 5): the Tanner graph's *edges* are sharded across the
mesh while the (bit-packed) variable state is replicated.

Random-ensemble LDPC graphs have no spatial locality (the edge permutation
is uniform), so a graph partition has no small halo -- every device needs
most of the variable state.  The right collective is therefore a full
OR-all-reduce of the per-device "newly resolvable" candidates rather than
neighbour halo exchange:

  per iteration, on each device:
    1. gather replicated known-planes for the LOCAL checks (1/D of the
       global gather traffic -- the work that motivates sharding),
    2. prefix/suffix AND -> per-socket validity,
    3. scatter-OR the valid sockets into a candidate plane [n, W],
    4. OR-all-reduce candidates across the mesh (all_gather + OR),
    5. known |= candidates   (replicated state stays consistent).

State cost: known is uint32[n, W]; at n=10^6, W=4 that is 16 MB -- far
under HBM, so replication is cheap and the sharding divides the dominant
cost (the [E, W] gathers) by the device count.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..models.code import LDPCCode
from ..ops.bitops import total_popcount
from ..ops.erasure_bp import PackedBPResult


def _or_all_reduce(x: jax.Array, axis_name: str) -> jax.Array:
    """Bitwise-OR all-reduce (psum cannot OR packed planes: carries)."""
    gathered = jax.lax.all_gather(x, axis_name)          # [D, n, W]
    return jnp.bitwise_or.reduce(gathered, axis=0)


def _local_round(chk_local: jax.Array, var_to_chk: jax.Array,
                 chk_offset, known: jax.Array, dc: int, dv: int
                 ) -> jax.Array:
    """Candidate plane from this device's check shard.

    Check side: per-socket gathers + prefix/suffix AND give the
    exactly-one-unknown summary for the LOCAL checks (same identity as
    ops.erasure_bp._check_summaries).  Variable side: every variable
    gathers the summary from its dv checks, with checks outside this
    device's shard masked to zero -- all gathers, no scatter (a
    3E-update scatter-OR under a 200-round while_loop would serialise
    on colliding updates; the OR-all-reduce then merges the per-shard
    candidates).
    """
    kns = [jnp.take(known, chk_local[:, j], axis=0) for j in range(dc)]
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

    m_local = chk_local.shape[0]
    cand = jnp.zeros_like(known)
    for p in range(dv):
        idx = var_to_chk[:, p] - chk_offset                  # [n]
        local = (idx >= 0) & (idx < m_local)
        plane = jnp.take(exactly_one, jnp.clip(idx, 0, m_local - 1),
                         axis=0)
        cand = cand | jnp.where(local[:, None], plane, jnp.uint32(0))
    return cand


def edge_sharded_bp_decode(code: LDPCCode, erased: jax.Array,
                           max_iters: int, mesh: Mesh) -> PackedBPResult:
    """All-zero-codeword erasure BP with the check/edge set sharded.

    Bit-identical results to
    :func:`..ops.erasure_bp.bp_decode_packed_allzero` (same fixed point,
    same per-iteration error totals); the iteration work is split across
    ``mesh`` and candidates are OR-all-reduced each round.
    """
    if code.m % mesh.size:
        raise ValueError(f"mesh size {mesh.size} must divide the check "
                         f"count m={code.m}")
    return _edge_sharded_core(code.chk_to_var, code.var_to_chk, erased,
                              code.dc, code.dv, max_iters, mesh)


def edge_sharded_bp_decode_irregular(code, erased: jax.Array,
                                     max_iters: int, mesh: Mesh
                                     ) -> PackedBPResult:
    """Edge-sharded decode for an :class:`..models.irregular
    .IrregularLDPCCode` -- huge-n Monte Carlo on irregular ensembles.

    The phantom padding makes the sharded core degree-agnostic: the
    state grows a permanently-known phantom-variable row, and the check
    table (already phantom-padded to ``dc_max``, phantom row included) is
    padded with extra all-phantom rows until the mesh size divides it --
    phantom rows are all-known, so their exactly-one-unknown summary is
    identically zero on whichever device owns them.  Bit-identical to
    :func:`..ops.erasure_bp.bp_decode_packed_allzero_irregular`.
    """
    from ..ops.erasure_bp import _pad_phantom_row, _strip_phantom

    m_pad = code.m + 1
    extra = (-m_pad) % mesh.size
    chk = code.chk_to_var
    if extra:
        chk = jnp.concatenate(
            [chk, jnp.full((extra, code.dc_max), code.n, jnp.int32)])
    res = _edge_sharded_core(chk, code.var_to_chk,
                             _pad_phantom_row(erased),
                             code.dc_max, code.dv_max, max_iters, mesh)
    return _strip_phantom(res)


def _edge_sharded_core(chk_rows: jax.Array, var_to_chk: jax.Array,
                       erased: jax.Array, dc: int, dv: int,
                       max_iters: int, mesh: Mesh) -> PackedBPResult:
    """Degree-agnostic sharded fixed-point loop over explicit tables."""
    axis = mesh.axis_names[0]
    n_dev = mesh.size
    m_rows = chk_rows.shape[0]
    if m_rows % n_dev:
        raise ValueError(f"mesh size {n_dev} must divide the (padded) "
                         f"check row count {m_rows}")
    n, W = erased.shape
    from ..ops.erasure_bp import _check_packed_batch_bits

    _check_packed_batch_bits(n, W)
    m_local = m_rows // n_dev

    def per_device(chk_local, var_to_chk, erased_rep):
        chk_offset = jax.lax.axis_index(axis).astype(jnp.int32) * m_local
        known = ~erased_rep
        # popcount the erased bits directly (the n*W*32 constant
        # overflows the int32 operand past 2^31 total batch bits)
        count0 = total_popcount(~known).astype(jnp.int32)
        errors = jnp.zeros(max_iters + 1, jnp.int32).at[0].set(count0)

        def cond(carry):
            _, _, it, count, changed = carry
            return (it < max_iters) & changed & (count > 0)

        def body(carry):
            known, errors, it, count, _ = carry
            cand = _local_round(chk_local, var_to_chk, chk_offset,
                                known, dc, dv)
            cand = _or_all_reduce(cand, axis)
            known = known | cand
            new_count = total_popcount(~known).astype(jnp.int32)
            errors = errors.at[it + 1].set(new_count)
            return (known, errors, it + 1, new_count, new_count != count)

        known, errors, it, count, _ = jax.lax.while_loop(
            cond, body, (known, errors, jnp.int32(0), count0, count0 > -1))
        tail = jnp.arange(max_iters + 1) > it
        errors = jnp.where(tail, count, errors)
        return known, errors, it

    # check_vma=False is a genuine expressiveness limit of jax 0.9.0's
    # varying-manual-axes lattice, not a bug here: the OR-all-reduce
    # (all_gather + reduce) returns a value that is bit-identical on every
    # device, but the checker still types all_gather output as varying and
    # offers no varying->invarying pcast (jax.lax.pcast supports only
    # invarying->varying/reduced, varying->unreduced, reduced->varying).
    # The replicated fixed-point carry therefore cannot be typed.  The
    # replication itself is proven by tests/test_edge_sharded.py's
    # bit-identity against the single-device decoder.
    sharded = jax.jit(jax.shard_map(
        per_device, mesh=mesh,
        in_specs=(P(axis, None), P(), P()),
        out_specs=(P(), P(), P()),
        check_vma=False,
    ))
    known, errors, it = sharded(chk_rows, var_to_chk, erased)
    return PackedBPResult(val=jnp.zeros_like(known), known=known,
                          error_totals=errors, iterations=it)
