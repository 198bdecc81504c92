"""Batched, optionally multi-chip Monte Carlo BER/FER engine.

Re-designs the reference's trial loop (parallel_simulator.py:198-244: one
code + one codeword + one C call per Python iteration) as chunked batch
decoding: each chunk decodes ``cfg.batch`` trials bit-packed on device, and
the host loop applies the reference's stopping rules at chunk granularity
(>=200 block errors / num_tests / wall clock, parallel_simulator.py:198).

Sharding: one ``shard_map`` over a 1-axis device mesh; each device decodes
``batch / n_devices`` trials with a key folded by its mesh position, and the
integer counters (per-iteration erasure totals, block errors, bit errors)
are ``psum``'d -- the collective replacement for the reference's
file-based shard reduction (tools/combine_data.py:32-95).

Seeding: chunk c on device d uses fold_in(fold_in(key(seed), c), d), so any
run is bit-reproducible at fixed (seed, batch, device count) -- a property
the reference lacks (random_code_generator.c:23 ignores its seed).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from datetime import datetime
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..models.code import LDPCCode
from ..models.ensemble import sample_check_table
from ..models.code import code_from_checks
from ..models.irregular import IrregularLDPCCode
from ..ops.bitops import bernoulli_packed
from ..ops.erasure_bp import (bp_decode_packed, bp_decode_packed_allzero,
                              bp_decode_packed_allzero_irregular,
                              bp_decode_packed_irregular)
from ..utils.config import SimulationConfig
from ..utils.results import SimulationResult
from .mesh import BATCH_AXIS, make_mesh


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ChunkStats:
    """Device-side accumulator for one chunk of trials.

    Counters are exact int32; ``bit_errors_sq`` -- the sum of squared
    per-trial final error counts, feeding the block-level BER variance
    estimate (utils.stats.ber_ci) -- is f32 (values can exceed int32 and
    it is a statistical moment, not a counter; f32's ~1e-7 relative error
    is negligible against Monte Carlo CI widths).
    """

    error_totals: jax.Array   # int32[iterations+1], summed over counted trials
    block_errors: jax.Array   # int32 scalar
    bit_errors: jax.Array     # int32 scalar (final erasures, counted trials)
    excluded: jax.Array       # int32 scalar (expurgation-gated trials)
    bit_errors_sq: jax.Array  # f32 scalar, sum of per-trial error count^2
    # f32 scalar, sum over fresh codes of (per-code total bit errors)^2:
    # the cluster-level second moment.  Trials sharing a code are
    # positively correlated, so ensemble-mode CIs must use the per-code
    # cluster variance, not the per-trial one (utils.stats.ber_ci).
    # None outside ensemble mode.
    code_bit_errors_sq: Optional[jax.Array] = None


def _allzero_decode(code, erased: jax.Array, iterations: int):
    """Dispatch the all-zero packed decode by code family."""
    if isinstance(code, IrregularLDPCCode):
        return bp_decode_packed_allzero_irregular(code, erased, iterations)
    return bp_decode_packed_allzero(code, erased, iterations)


def _bp_chunk(code, key: jax.Array, *, n: int, words: int,
              iterations: int, erasure_prob,
              expurgation: Optional[int],
              enc_planes=None) -> ChunkStats:
    """Decode 32*words trials on one code (regular LDPCCode or
    IrregularLDPCCode).  ``enc_planes`` (from models.encode
    .encoder_planes) switches to random-codeword transmit: fresh
    information bits are encoded on device and errors are counted against
    the true codeword -- unresolved erasures plus any miscopied known bit
    (provably zero on the BEC; counted anyway so the invariant is
    *measured*, not assumed)."""
    if enc_planes is not None:
        from ..models.encode import encode_packed
        from ..ops.bitops import per_trial_counts

        if expurgation is not None:
            # loud, not silent: this branch returns ungated statistics
            # (the config guard forbids the combination; keep the trap
            # armed for direct callers)
            raise NotImplementedError(
                "random-transmit BEC chunks do not implement expurgation")
        k_noise, k_info = jax.random.split(key)
        erased = bernoulli_packed(k_noise, erasure_prob, (n, words))
        k_eff = enc_planes[0].shape[1]
        info = bernoulli_packed(k_info, 0.5, (k_eff, words))
        tx = encode_packed(enc_planes, info, n=n)
        decode = (bp_decode_packed_irregular
                  if isinstance(code, IrregularLDPCCode)
                  else bp_decode_packed)
        res = decode(code, erased, tx, iterations)
        err_planes = ~res.known | ((res.val ^ tx) & res.known)
        per_trial = per_trial_counts(err_planes, axis=0)
        return ChunkStats(
            error_totals=res.error_totals,
            block_errors=jnp.sum(per_trial > 0).astype(jnp.int32),
            bit_errors=jnp.sum(per_trial).astype(jnp.int32),
            excluded=jnp.int32(0),
            bit_errors_sq=jnp.sum(jnp.square(per_trial
                                             .astype(jnp.float32))))
    erased = bernoulli_packed(key, erasure_prob, (n, words))
    if expurgation is None:
        # all-zero transmit (the reference's only workload,
        # parallel_simulator.py:222) -> known-mask-only fast path
        res = _allzero_decode(code, erased, iterations)
        per_trial = res.bit_errors
        return ChunkStats(
            error_totals=res.error_totals,
            block_errors=jnp.sum(res.failed).astype(jnp.int32),
            bit_errors=jnp.sum(per_trial).astype(jnp.int32),
            excluded=jnp.int32(0),
            bit_errors_sq=jnp.sum(jnp.square(per_trial.astype(jnp.float32))),
        )
    # Expurgated ensemble: drop whole trials with <= s final erasures from
    # *all* statistics, while still counting them as trials
    # (parallel_simulator_expurgated.py:238-243).
    #
    # Two-pass formulation: pass 1 decodes normally and reads only the
    # final per-trial counts (one 32-plane extraction total); pass 2
    # re-decodes with the excluded trials' erasures masked out, so those
    # trials contribute zero to every per-iteration total -- the plain
    # scalar totals then equal the expurgated sums exactly (the decode is
    # a deterministic function of the erasure pattern).  ~2x decode cost
    # instead of ~30x for per-iteration per-trial counting.
    from ..ops.bitops import pack_bits

    res1 = _allzero_decode(code, erased, iterations)
    final = res1.bit_errors                                  # int32[B]
    include = final > expurgation                            # bool[B]
    include_words = pack_bits(include[None, :])[0]           # uint32[W]
    res2 = _allzero_decode(
        code, erased & include_words[None, :], iterations)
    return ChunkStats(
        error_totals=res2.error_totals,
        block_errors=jnp.sum(include & (final > 0)).astype(jnp.int32),
        bit_errors=jnp.sum(final * include).astype(jnp.int32),
        excluded=jnp.sum(~include).astype(jnp.int32),
        bit_errors_sq=jnp.sum(jnp.square((final * include)
                                         .astype(jnp.float32))),
    )


def _final_count_stats(error_totals, final, expurgation, traj=None
                       ) -> ChunkStats:
    """ChunkStats from per-trial final error counts, with the
    expurgation gate (trials with final <= s excluded from block/bit
    statistics but still counted, parallel_simulator_expurgated.py:238).

    Soft/hard-decision decodes are not monotone in a masked input, so
    the BEC path's two-pass re-decode trick is unavailable; instead the
    expurgated chunks decode with ``record="per_trial"`` and pass the
    int32[iterations+1, B] ``traj``, from which the per-iteration series
    is summed over *included trials only* -- exactly the reference's
    expurgated accumulation (parallel_simulator_expurgated.py:238-243).
    """
    if expurgation is None:
        include = jnp.ones_like(final, bool)
    else:
        include = final > expurgation
        if traj is not None:
            error_totals = jnp.sum(
                jnp.where(include[None, :], traj, 0), axis=1)
    gated = final * include
    return ChunkStats(
        error_totals=error_totals,
        block_errors=jnp.sum(include & (final > 0)).astype(jnp.int32),
        bit_errors=jnp.sum(gated).astype(jnp.int32),
        excluded=jnp.sum(~include).astype(jnp.int32),
        bit_errors_sq=jnp.sum(jnp.square(gated.astype(jnp.float32))),
    )


def _gallager_chunk(code: LDPCCode, key: jax.Array, *, n: int, words: int,
                    iterations: int, crossover_prob,
                    threshold=None, expurgation=None,
                    enc_planes=None) -> ChunkStats:
    """BSC hard-decision chunk: packed flip mask -> Gallager-A/B decode
    (regular LDPCCode or IrregularLDPCCode).  ``enc_planes`` switches to
    random-codeword transmit (received = tx ^ flips, errors vs tx --
    the measured BSC channel-symmetry check; the Gallager update is
    XOR-affine in a codeword shift, so the equivalence is bit-exact,
    tests/test_gallager_soft.py::test_gallager_codeword_symmetry)."""
    from ..ops.gallager import (gallager_decode_packed,
                                gallager_decode_packed_irregular)

    tx = None
    if enc_planes is None:
        received = bernoulli_packed(key, crossover_prob, (n, words))
    else:
        from ..models.encode import encode_packed

        k_noise, k_info = jax.random.split(key)
        flips = bernoulli_packed(k_noise, crossover_prob, (n, words))
        info = bernoulli_packed(k_info, 0.5,
                                (enc_planes[0].shape[1], words))
        tx = encode_packed(enc_planes, info, n=n)
        received = tx ^ flips
    decode = (gallager_decode_packed_irregular
              if isinstance(code, IrregularLDPCCode)
              else gallager_decode_packed)
    res = decode(code, received, iterations, threshold=threshold,
                 record="total" if expurgation is None else "per_trial",
                 tx_bits=tx)
    return _final_count_stats(res.error_totals, res.bit_errors,
                              expurgation, traj=res.traj)


def _soft_chunk(code: LDPCCode, key: jax.Array, *, n: int, batch: int,
                iterations: int, channel: str, channel_param,
                method: str, alpha: float = 1.0, beta: float = 0.0,
                msg_dtype=jnp.float32, enc_planes=None,
                expurgation=None) -> ChunkStats:
    """AWGN/BSC soft-decision chunk: LLRs -> min-sum or sum-product BP
    (regular LDPCCode or IrregularLDPCCode).  ``enc_planes`` switches to
    random-codeword transmit (errors counted against the true codeword --
    the measured channel-symmetry check, cf. the reference's always-zero
    transmit, parallel_simulator.py:222)."""
    from ..ops.channels import AWGN, BSC
    from ..ops.soft_bp import soft_bp_decode, soft_bp_decode_irregular

    tx_bits = None
    if enc_planes is None:
        tx = jnp.zeros((n, batch), jnp.int32)
        k_noise = key
    else:
        from ..models.encode import encode_packed
        from ..ops.bitops import unpack_bits

        k_noise, k_info = jax.random.split(key)
        k_eff = enc_planes[0].shape[1]
        info = bernoulli_packed(k_info, 0.5, (k_eff, batch // 32))
        tx_bits = unpack_bits(encode_packed(enc_planes, info,
                                            n=n))  # bool[n, B]
        tx = tx_bits.astype(jnp.int32)
    if channel == "AWGN":
        ch = AWGN(channel_param)
        llr = ch.llr(ch.transmit(k_noise, tx))
    else:
        ch = BSC(channel_param)
        llr = ch.llr(ch.transmit(k_noise, tx))
    decode = (soft_bp_decode_irregular
              if isinstance(code, IrregularLDPCCode) else soft_bp_decode)
    res = decode(code, llr, iterations, method=method,
                 alpha=alpha, beta=beta, msg_dtype=msg_dtype,
                 tx_bits=tx_bits,
                 record="total" if expurgation is None else "per_trial")
    return _final_count_stats(res.error_totals, res.bit_errors,
                              expurgation, traj=res.traj)


def _fresh_codes_chunk(key: jax.Array, *, num_codes: int, sample_fn,
                       decode_one) -> ChunkStats:
    """Fresh-codes chunk: num_codes codes from ``sample_fn(key)``, each
    decoded by ``decode_one(code, noise_key) -> ChunkStats`` on its own
    trial sub-batch (reference mode 0 draws a fresh code per trial,
    parallel_simulator.py:198-221; here trials sharing a code are the 32
    packing lanes -- set codes_per_chunk=batch/32 for one code per lane
    group).  The single combinator for every code family and device
    decoder; also records the per-code cluster second moment for the
    clustered CI."""
    kc, kx = jax.random.split(key)
    code_keys = jax.random.split(kc, num_codes)
    noise_keys = jax.random.split(kx, num_codes)

    def one(code_key, noise_key):
        return decode_one(sample_fn(code_key), noise_key)

    return _reduce_code_stats(jax.vmap(one)(code_keys, noise_keys))


def _reduce_code_stats(stats: ChunkStats) -> ChunkStats:
    """Sum vmapped per-code ChunkStats; records the per-code cluster
    second moment for the clustered CI (utils.stats.ber_ci)."""
    return ChunkStats(
        error_totals=jnp.sum(stats.error_totals, axis=0),
        block_errors=jnp.sum(stats.block_errors),
        bit_errors=jnp.sum(stats.bit_errors),
        excluded=jnp.sum(stats.excluded),
        bit_errors_sq=jnp.sum(stats.bit_errors_sq),
        code_bit_errors_sq=jnp.sum(
            jnp.square(stats.bit_errors.astype(jnp.float32))),
    )


def _given_codes_chunk(key: jax.Array, *, codes, planes,
                       decode_one) -> ChunkStats:
    """Ensemble chunk over HOST-provided codes (+ padded encoder planes).

    The random-transmit ensemble path: fresh codes still come one per
    32-trial lane group and are derived from this chunk's key -- but the
    systematic-encoder derivation is host-bound GF(2) elimination, so
    ``make_chunk_fn`` samples the codes on the host with the *same* key
    split as :func:`_fresh_codes_chunk` (kc -> per-code keys; the codes
    of a given (seed, chunk) are identical to the zero-transmit run's)
    and ships the batched code pytree + padded planes as traced args.
    ``decode_one(code, planes_i, noise_key) -> ChunkStats``.
    """
    _, kx = jax.random.split(key)
    num_codes = planes[0].shape[0]
    noise_keys = jax.random.split(kx, num_codes)
    stats = jax.vmap(decode_one)(codes, planes, noise_keys)
    return _reduce_code_stats(stats)


def _ensemble_layout(cfg: SimulationConfig, n_dev: int):
    """(codes per device-chunk, words per code) for ensemble mode.

    One place so the chunk kernel and the driver's cluster-size accounting
    (trials_per_code = 32 * words_per_code) can never disagree."""
    words = cfg.batch // 32 // n_dev
    num_codes = max(cfg.codes_per_chunk // n_dev, 1)
    while words % num_codes:
        num_codes -= 1  # keep trial accounting exact
    return num_codes, words // num_codes


#: compiled chunk kernels keyed by their static configuration -- the
#: channel parameter and the fixed code are TRACED arguments, so an
#: eps/sigma sweep (or a fixed-code concentration study) reuses one
#: compiled executable instead of recompiling per point.  Bounded FIFO
#: (compiled executables hold device buffers).  Across processes the
#: persistent compile cache (utils.runtime.enable_compile_cache) keeps
#: the compiled programs.
_CHUNK_CACHE: dict = {}
_CHUNK_CACHE_MAX = 32


def _chunk_static_key(cfg: SimulationConfig, mesh, n_dev: int):
    return (cfg.channel, cfg.decoder, cfg.code_mode, cfg.n, cfg.dv, cfg.dc,
            tuple(cfg.lam) if cfg.lam is not None else None,
            tuple(cfg.rho) if cfg.rho is not None else None,
            cfg.iterations, cfg.batch, cfg.sampler, cfg.expurgation,
            cfg.gallager_threshold, cfg.minsum_alpha, cfg.minsum_beta,
            cfg.soft_msg_dtype, cfg.codes_per_chunk,
            cfg.transmit, n_dev, mesh)


def _build_chunk_jit(cfg: SimulationConfig, mesh, n_dev: int):
    """Jitted ``fn(key, channel_param, code, enc_planes) -> ChunkStats``.

    Every static the trace reads is part of :func:`_chunk_static_key`;
    the channel parameter, the fixed code's arrays, and the encoder
    planes flow in as traced arguments.
    """
    pair = (cfg.channel, cfg.decoder)
    words = cfg.batch // 32 // n_dev  # per-device words (packed decoders)

    def make_decode_one(sub_words: int, channel_param, enc_planes):
        def decode_one(c: LDPCCode, key: jax.Array) -> ChunkStats:
            if pair == ("BEC", "bp"):
                return _bp_chunk(c, key, n=cfg.n, words=sub_words,
                                 iterations=cfg.iterations,
                                 erasure_prob=channel_param,
                                 expurgation=cfg.expurgation,
                                 enc_planes=enc_planes)
            if pair == ("BSC", "gallager"):
                return _gallager_chunk(c, key, n=cfg.n, words=sub_words,
                                       iterations=cfg.iterations,
                                       crossover_prob=channel_param,
                                       threshold=cfg.gallager_threshold,
                                       expurgation=cfg.expurgation,
                                       enc_planes=enc_planes)
            return _soft_chunk(c, key, n=cfg.n, batch=sub_words * 32,
                               iterations=cfg.iterations, channel=cfg.channel,
                               channel_param=channel_param,
                               method=cfg.decoder, alpha=cfg.minsum_alpha,
                               beta=cfg.minsum_beta,
                               msg_dtype=jnp.dtype(cfg.soft_msg_dtype),
                               enc_planes=enc_planes,
                               expurgation=cfg.expurgation)

        return decode_one

    if cfg.code_mode == "fixed":
        def local_chunk(key, channel_param, code, enc_planes):
            decode_one = make_decode_one(words, channel_param, enc_planes)
            return decode_one(code, key)
    else:
        num_codes, wpc = _ensemble_layout(cfg, n_dev)

        if cfg.irregular:
            from ..models.irregular import IrregularEnsembleSpec

            spec = IrregularEnsembleSpec.from_lam_rho(cfg.n, cfg.lam,
                                                      cfg.rho)

            def sample_fn(key):
                return spec.sample(key, cfg.sampler)
        else:
            def sample_fn(key):
                chk = sample_check_table(key, cfg.n, cfg.dv, cfg.dc,
                                         cfg.sampler)
                return code_from_checks(chk, n=cfg.n, dv=cfg.dv, dc=cfg.dc)

        if cfg.transmit == "random":
            # host-provided codes + padded per-code encoder planes
            # (see _given_codes_chunk / make_chunk_fn)
            def local_chunk(key, channel_param, codes, enc_planes):
                return _given_codes_chunk(
                    key, codes=codes, planes=enc_planes,
                    decode_one=lambda c, p, nk: make_decode_one(
                        wpc, channel_param, p)(c, nk))
        else:
            def local_chunk(key, channel_param, code, enc_planes):
                return _fresh_codes_chunk(
                    key, num_codes=num_codes, sample_fn=sample_fn,
                    decode_one=make_decode_one(wpc, channel_param,
                                               enc_planes))

    if mesh is None:
        return jax.jit(local_chunk)

    def sharded_chunk(key, channel_param, code, enc_planes):
        def per_device(key, channel_param, code, enc_planes):
            idx = jax.lax.axis_index(BATCH_AXIS)
            stats = local_chunk(jax.random.fold_in(key, idx),
                                channel_param, code, enc_planes)
            return jax.tree.map(
                lambda x: jax.lax.psum(x, BATCH_AXIS), stats)

        return jax.shard_map(
            per_device, mesh=mesh,
            in_specs=(P(), P(), P(), P()),
            out_specs=P(),
        )(key, channel_param, code, enc_planes)

    return jax.jit(sharded_chunk)


def make_chunk_fn(cfg: SimulationConfig, code: Optional[LDPCCode],
                  mesh: Optional[Mesh] = None):
    """Build the jitted (and, with a mesh, shard_mapped) chunk kernel.

    Returns ``fn(key) -> ChunkStats`` decoding ``cfg.batch`` trials.
    Compiled executables are cached across calls by the static
    configuration (the channel parameter and fixed-code arrays are
    traced), so parameter sweeps compile once.
    """
    pair = (cfg.channel, cfg.decoder)
    device_decoders = {("BEC", "bp"), ("BSC", "gallager"),
                       ("BSC", "sumproduct"), ("BSC", "minsum"),
                       ("AWGN", "sumproduct"), ("AWGN", "minsum")}
    if pair not in device_decoders:
        raise NotImplementedError(
            f"{pair} runs through its own host driver (ml/both/peeling)")

    n_dev = 1 if mesh is None else mesh.size
    if cfg.batch % (32 * n_dev):
        raise ValueError("batch must divide by 32 * n_devices")

    if cfg.code_mode == "fixed" and code is None:
        raise ValueError("fixed code_mode requires a code")

    from ..models.qc import IrregularQCLDPCCode, QCLDPCCode

    if isinstance(code, (QCLDPCCode, IrregularQCLDPCCode)):
        # Hot case (fixed-code, zero transmit, no expurgation): the roll
        # decoder, whose rolls replace the gather decoder's random
        # gathers at huge n.  Every other mode expands to the
        # generic edge-list code; the statistics are IDENTICAL either
        # way (the roll decoder is bit-identical on expand(),
        # tests/test_qc.py), only throughput differs.
        if code.n != cfg.n:
            raise ValueError(f"QC code n={code.n} != cfg.n={cfg.n}")
        # soft fast path: int8 ONLY -- integer arithmetic makes the roll
        # decoder bit-identical to the generic one, so the engine's
        # counters are representation-independent; float dtypes differ
        # by addition-order roundoff and go through expand() instead
        soft_pairs = {("BSC", "minsum"), ("AWGN", "minsum")}
        fast = ((pair in (("BEC", "bp"), ("BSC", "gallager"))
                 or (pair in soft_pairs and cfg.soft_msg_dtype == "int8"))
                and cfg.code_mode == "fixed"
                and cfg.expurgation is None and cfg.transmit == "zero")
        if fast:
            return _make_qc_chunk_fn(cfg, code, mesh)
        code = code.expand()

    enc_planes = None
    if cfg.transmit == "random" and cfg.code_mode == "fixed":
        # derive the systematic encoder once on the host, ship the GF(2)
        # map as traced arrays
        from ..models.encode import encoder_planes, make_encoder
        from ..ops.ml import _dense_of

        if code is None:
            raise ValueError("transmit='random' requires a fixed code")
        enc_planes = encoder_planes(make_encoder(h=_dense_of(code)))

    static_key = _chunk_static_key(cfg, mesh, n_dev)
    jitted = _CHUNK_CACHE.get(static_key)
    if jitted is None:
        if len(_CHUNK_CACHE) >= _CHUNK_CACHE_MAX:
            _CHUNK_CACHE.pop(next(iter(_CHUNK_CACHE)))
        jitted = _build_chunk_jit(cfg, mesh, n_dev)
        _CHUNK_CACHE[static_key] = jitted

    channel_param = jnp.float32(cfg.channel_param)

    if cfg.transmit == "random" and cfg.code_mode == "ensemble":
        # Fresh codes need fresh systematic encoders -- host-bound GF(2)
        # eliminations -- so this validation-scale mode samples the
        # chunk's codes on the host with the SAME key split as
        # _fresh_codes_chunk (identical codes to the zero-transmit run
        # at equal (seed, chunk)) and ships the batched pytree + padded
        # planes as traced args.  Single-device: per-device host
        # sampling under shard_map is not available.
        if mesh is not None:
            raise ValueError(
                "transmit='random' ensemble mode runs single-device "
                "(per-chunk host-side encoder derivation); drop the mesh")
        from ..models.encode import encoder_planes_padded, make_encoder
        from ..ops.ml import _dense_of

        num_codes, _ = _ensemble_layout(cfg, 1)
        if cfg.irregular:
            from ..models.irregular import IrregularEnsembleSpec

            spec = IrregularEnsembleSpec.from_lam_rho(cfg.n, cfg.lam,
                                                      cfg.rho)
            sample_host = lambda k: spec.sample(k, cfg.sampler)
        else:
            sample_host = lambda k: code_from_checks(
                sample_check_table(k, cfg.n, cfg.dv, cfg.dc, cfg.sampler),
                n=cfg.n, dv=cfg.dv, dc=cfg.dc)

        def fn(key):
            kc, _ = jax.random.split(key)
            codes = [sample_host(k)
                     for k in jax.random.split(kc, num_codes)]
            encs = [make_encoder(h=_dense_of(c)) for c in codes]
            planes = encoder_planes_padded(encs, cfg.n)
            batched = jax.tree.map(lambda *xs: jnp.stack(xs), *codes)
            return jitted(key, channel_param, batched, planes)

        return fn

    fixed_code = code if cfg.code_mode == "fixed" else None
    return lambda key: jitted(key, channel_param, fixed_code, enc_planes)


def _make_qc_chunk_fn(cfg: SimulationConfig, code,
                      mesh: Optional[Mesh] = None):
    """Roll-decoder chunk kernel for a fixed quasi-cyclic code: the
    zero-transmit BEC+bp, BSC+gallager, and int8-min-sum cases (the
    soft chunk draws the same LLRs from the same key as _soft_chunk, so
    the int8 engine path is bit-identical to running on expand()).
    The QC code's adjacency is STATIC (the
    rolls' shifts must be compile-time constants), so the code is
    closed over rather than traced; the compile cache keys on the
    adjacency tuples, which fully determine the code.  With a mesh, the
    trial batch is sharded exactly like the generic engine (per-device
    key fold + psum'd counters), so counters are independent of the
    device count in the same way."""
    from ..ops.qc_bp import _adjacency, qc_bp_decode_packed_allzero

    chk_side, _ = _adjacency(code)
    pair = (cfg.channel, cfg.decoder)
    n_dev = 1 if mesh is None else mesh.size
    words = cfg.batch // 32 // n_dev
    # type(code) is part of the key: a regular and an irregular QC code
    # with coincident adjacency decode Gallager differently (raw vs
    # clamped threshold rule)
    static_key = ("qc", type(code).__name__, chk_side, code.Z, cfg.n,
                  words, cfg.iterations, pair, cfg.soft_msg_dtype,
                  cfg.minsum_alpha, cfg.minsum_beta,
                  cfg.gallager_threshold, mesh)
    jitted = _CHUNK_CACHE.get(static_key)
    if jitted is None:
        def local_chunk(key, channel_param):
            if pair == ("BEC", "bp"):
                erased = bernoulli_packed(key, channel_param,
                                          (cfg.n, words))
                res = qc_bp_decode_packed_allzero(code, erased,
                                                  cfg.iterations)
            elif pair == ("BSC", "gallager"):
                from ..ops.qc_gallager import qc_gallager_decode_packed

                received = bernoulli_packed(key, channel_param,
                                            (cfg.n, words))
                res = qc_gallager_decode_packed(
                    code, received, cfg.iterations,
                    threshold=cfg.gallager_threshold)
            else:
                from ..ops.channels import AWGN, BSC
                from ..ops.qc_soft_bp import qc_soft_bp_decode

                ch_cls = AWGN if cfg.channel == "AWGN" else BSC
                ch = ch_cls(channel_param)
                llr = ch.llr(ch.transmit(
                    key, jnp.zeros((cfg.n, 32 * words), jnp.int32)))
                res = qc_soft_bp_decode(
                    code, llr, cfg.iterations, method=cfg.decoder,
                    alpha=cfg.minsum_alpha, beta=cfg.minsum_beta,
                    msg_dtype=jnp.dtype(cfg.soft_msg_dtype))
            return _final_count_stats(res.error_totals, res.bit_errors,
                                      None)

        if mesh is None:
            chunk = local_chunk
        else:
            def chunk(key, channel_param):
                def per_device(key, channel_param):
                    idx = jax.lax.axis_index(BATCH_AXIS)
                    stats = local_chunk(jax.random.fold_in(key, idx),
                                        channel_param)
                    return jax.tree.map(
                        lambda x: jax.lax.psum(x, BATCH_AXIS), stats)

                return jax.shard_map(per_device, mesh=mesh,
                                     in_specs=(P(), P()),
                                     out_specs=P())(key, channel_param)

        if len(_CHUNK_CACHE) >= _CHUNK_CACHE_MAX:
            _CHUNK_CACHE.pop(next(iter(_CHUNK_CACHE)))
        jitted = _CHUNK_CACHE[static_key] = jax.jit(chunk)

    channel_param = jnp.float32(cfg.channel_param)
    return lambda key: jitted(key, channel_param)


def make_edge_sharded_chunk_fn(cfg: SimulationConfig, code: LDPCCode,
                               mesh: Mesh):
    """Chunk kernel for huge-n fixed-code runs: the *graph* is sharded
    across the mesh (parallel/edge_sharded.py) while the trial batch is
    replicated.  Counters are bit-identical to the unsharded engine's for
    the same (seed, batch): the same chunk keys draw the same erasures
    and the edge-sharded decoder reaches the same fixed point -- so a
    mesh-size change never changes the statistics, only the wall clock.

    This is the Monte-Carlo closure of SURVEY section 5's long-context
    analogue: FER/waterfall statistics at n = 10^5..10^6, beyond the
    reference's largest plotted n = 10^5 (tools/plotting.py:357)."""
    from ..models.qc import IrregularQCLDPCCode, QCLDPCCode
    from .edge_sharded import (edge_sharded_bp_decode,
                               edge_sharded_bp_decode_irregular)

    if isinstance(code, (QCLDPCCode, IrregularQCLDPCCode)):
        code = code.expand()   # statistics identical; see make_chunk_fn
    words = cfg.batch // 32
    if isinstance(code, IrregularLDPCCode):
        decode = edge_sharded_bp_decode_irregular  # pads rows itself
    else:
        decode = edge_sharded_bp_decode
        if code.m % mesh.size:
            raise ValueError(f"mesh size {mesh.size} must divide the "
                             f"check count m={code.m} (pick a device "
                             "count that divides m)")

    # the eps sweep at huge n reuses one executable: channel_param and
    # the code arrays are traced; statics key the cache (same scheme as
    # make_chunk_fn).  The decode dispatch is by code *type*, which is
    # part of the key.
    static_key = ("edge_sharded", type(code).__name__, cfg.n, words,
                  cfg.iterations, mesh)
    jitted = _CHUNK_CACHE.get(static_key)
    if jitted is None:
        def chunk(key, channel_param, code):
            erased = bernoulli_packed(key, channel_param, (cfg.n, words))
            res = decode(code, erased, cfg.iterations, mesh)
            per_trial = res.bit_errors
            return ChunkStats(
                error_totals=res.error_totals,
                block_errors=jnp.sum(res.failed).astype(jnp.int32),
                bit_errors=jnp.sum(per_trial).astype(jnp.int32),
                excluded=jnp.int32(0),
                bit_errors_sq=jnp.sum(jnp.square(
                    per_trial.astype(jnp.float32))),
            )

        if len(_CHUNK_CACHE) >= _CHUNK_CACHE_MAX:
            _CHUNK_CACHE.pop(next(iter(_CHUNK_CACHE)))
        jitted = _CHUNK_CACHE[static_key] = jax.jit(chunk)

    channel_param = jnp.float32(cfg.channel_param)
    return lambda key: jitted(key, channel_param, code)


def _require_single_process(driver: str) -> None:
    """The host-path drivers run no collectives and no wall-clock
    broadcast (unlike the main loop, which broadcasts process 0's clock
    each chunk); under a multi-process job they would each repeat the full
    num_tests and could stop at divergent points.  Guard rather than trap
    whoever first adds a psum'd stage to one of them."""
    if jax.process_count() > 1:
        raise RuntimeError(
            f"the {driver} driver is single-process only: it has no "
            "psum'd counters and no wall-clock broadcast; run it outside "
            "the jax.distributed job")


def _run_ml_or_both(cfg: SimulationConfig, code: Optional[LDPCCode]
                    ) -> SimulationResult:
    """Host-path driver for the ML (optimal) decoder, optionally alongside
    BP on the *same* channel outputs (reference modes 1/2/4/5,
    parallel_simulator.py:233-242: both decoders see one transmission).

    ML is the small-n optimality oracle (O(n^3) per trial); the channel +
    BP side runs in device batches and the GF(2) eliminations go through
    ONE native C call per chunk (native/gf2.c ml_decode_trials) -- the
    batched replacement for the reference's per-trial galois loop
    (parallel_simulator.py:60-129).

    Single-process by design (the blessed way to scale it is the
    reference's own: independent array jobs over seeds, reduced exactly
    by ``utils.combine.combine_results`` -- every counter this driver
    emits is a raw count, so the merge is integer addition; see
    README "Scaling the host-path drivers" and
    tests/test_montecarlo_ml.py::test_ml_array_job_combine_recipe).
    """
    from ..models.ensemble import sample_codes
    from ..ops.bitops import pack_bits
    from ..ops.erasure_bp import (bp_decode, bp_decode_irregular,
                                  bp_decode_packed_irregular)
    from ..ops.ml import ml_decode_batch, ml_decode_batch_ensemble

    _require_single_process("ml/both")
    run_bp = cfg.decoder == "both"
    ensemble = cfg.code_mode != "fixed"
    irr_spec = None
    if cfg.irregular:
        from ..models.irregular import IrregularEnsembleSpec

        irr_spec = IrregularEnsembleSpec.from_lam_rho(cfg.n, cfg.lam,
                                                      cfg.rho)
    key = jax.random.key(cfg.seed)
    start = time.time()
    trials = chunk_idx = 0
    error_totals = np.zeros(cfg.iterations + 1, np.int64)
    block_errors = bit_errors = 0
    bit_errors_sq = 0.0
    opt_block = opt_bit = 0
    stopped_by = "num_tests"
    # ML is O(n^3) host work per trial; chunks larger than 512 only grow
    # the native call's working set without amortising anything more, so
    # the driver caps them -- loudly, so a cfg.batch=4096 user is not
    # silently downgraded (see SimulationConfig.batch docs).
    batch = min(cfg.batch, 512)
    batch -= batch % 32
    if batch < cfg.batch:
        import warnings

        warnings.warn(
            f"ml/both driver caps the chunk batch at {batch} trials "
            f"(cfg.batch={cfg.batch}); statistics are unaffected, only "
            "chunk granularity", stacklevel=2)

    if run_bp and ensemble:
        # per-trial fresh codes: vmap the naive decoder over the stacked
        # code pytree (one dispatch per chunk instead of `batch`)
        bp_oracle = bp_decode_irregular if irr_spec else bp_decode
        bp_errs_vmapped = jax.jit(jax.vmap(
            lambda c, rx: bp_oracle(c, rx, cfg.iterations)[1]))

    while trials < cfg.num_tests:
        ck = jax.random.fold_in(key, chunk_idx)
        k_code, k_noise = jax.random.split(ck)
        masks = np.asarray(jax.random.uniform(k_noise, (batch, cfg.n))
                           < cfg.channel_param)
        rx = np.where(masks, 2, 0).astype(np.uint8)        # [batch, n]

        if ensemble:
            if irr_spec is not None:
                codes = spec_batch = irr_spec.sample_batch(
                    k_code, batch, cfg.sampler)             # batched pytree
                chk = np.asarray(spec_batch.chk_to_var)[:, :-1]  # drop
                # the phantom row; padding entries (== n) are skipped by
                # the kernel (ops/ml.ml_decode_batch_ensemble)
            else:
                codes = sample_codes(k_code, batch, cfg.n, cfg.dv, cfg.dc,
                                     cfg.sampler)           # batched pytree
                chk = np.asarray(codes.chk_to_var)
            dec = ml_decode_batch_ensemble(chk, cfg.n, rx)
        else:
            dec = ml_decode_batch(code, rx)

        undet = (dec == 2).sum(axis=1)
        opt_block += int((undet > 0).sum())
        opt_bit += int(undet.sum())

        if run_bp:
            if not ensemble:
                erased = pack_bits(jnp.asarray(masks.T))
                tx = jnp.zeros_like(erased)
                packed_bp = (bp_decode_packed_irregular if irr_spec
                             else bp_decode_packed)
                res = packed_bp(code, erased, tx, cfg.iterations)
                error_totals += np.asarray(res.error_totals, np.int64)
                block_errors += int(jnp.sum(res.failed))
                per_trial = np.asarray(res.bit_errors, np.int64)
                bit_errors += int(per_trial.sum())
                bit_errors_sq += float((per_trial.astype(float) ** 2).sum())
            else:
                # same codes AND same channel outputs as the ML side
                # (reference mode-2 semantics, parallel_simulator.py:233)
                errs = np.asarray(bp_errs_vmapped(
                    codes, jnp.asarray(rx, jnp.int32)), np.int64)
                error_totals += errs.sum(axis=0)
                finals = errs[:, -1]
                block_errors += int((finals != 0).sum())
                bit_errors += int(finals.sum())
                bit_errors_sq += float((finals.astype(float) ** 2).sum())

        trials += batch
        chunk_idx += 1
        stop_counter = block_errors if run_bp else opt_block
        if stop_counter >= cfg.max_block_errors:
            stopped_by = "block_errors"
            break
        if time.time() - start > cfg.max_seconds:
            stopped_by = "wall_clock"
            break

    elapsed = time.time() - start
    denom = cfg.n * trials
    return SimulationResult(
        config=cfg, num_trials=trials,
        error_rate_per_iteration=(error_totals / denom).tolist(),
        block_error_rate=block_errors / trials,
        bit_error_rate=bit_errors / denom,
        optimal_block_error_rate=opt_block / trials,
        optimal_bit_error_rate=opt_bit / denom,
        block_errors=block_errors, bit_errors=bit_errors,
        optimal_block_errors=opt_block, optimal_bit_errors=opt_bit,
        error_counts_per_iteration=error_totals.tolist(),
        bit_errors_sq=bit_errors_sq if run_bp else None,
        elapsed_seconds=elapsed,
        timestamp=datetime.now().strftime("%d-%m-%Y-%H-%M-%S"),
        stopped_by=stopped_by)


def _run_peeling(cfg: SimulationConfig, code: Optional[LDPCCode]
                 ) -> SimulationResult:
    """Monte Carlo with the peeling decoder.

    On the BEC the peeling decoder and erasure BP stop at the *identical*
    fixed point -- the maximal stopping set of the erasure pattern (the
    property the test suite uses as a decoder oracle) -- so the error
    *statistics* of peeling are computed with the bit-packed BP kernel run
    to its fixed point (an n-round budget guarantees it: every productive
    round resolves at least one variable).  This is ~1000x faster than
    stepping the sequential R-process per trial; the genuine one-peel-at-
    a-time trajectory decoder (reference peeling_decoder.py:47-82
    semantics) remains `ops.peeling.peel_decode` and drives the scaling
    experiments in `utils.experiments`."""
    from ..models.ensemble import sample_code as _sample_code

    _require_single_process("peeling")
    if code is None and cfg.code_mode == "fixed":
        raise ValueError("fixed code_mode requires a code")
    irr_spec = None
    if cfg.irregular:
        from ..models.irregular import IrregularEnsembleSpec

        irr_spec = IrregularEnsembleSpec.from_lam_rho(cfg.n, cfg.lam,
                                                      cfg.rho)
    key = jax.random.key(cfg.seed)
    start = time.time()
    trials = chunk_idx = 0
    block_errors = bit_errors = 0
    bit_errors_sq = 0.0
    stopped_by = "num_tests"
    batch = cfg.batch  # __post_init__ guarantees batch % 32 == 0
    words = batch // 32
    while trials < cfg.num_tests:
        ck = jax.random.fold_in(key, chunk_idx)
        k_noise, k_code = jax.random.split(ck)
        if code is not None:
            chunk_code = code
        elif irr_spec is not None:
            chunk_code = irr_spec.sample(k_code, cfg.sampler)
        else:
            chunk_code = _sample_code(k_code, cfg.n, cfg.dv, cfg.dc,
                                      cfg.sampler)
        erased = bernoulli_packed(k_noise, cfg.channel_param,
                                  (cfg.n, words))
        res = _allzero_decode(chunk_code, erased, cfg.n)
        block_errors += int(jnp.sum(res.failed))
        per_trial = np.asarray(res.bit_errors, np.int64)
        bit_errors += int(per_trial.sum())
        bit_errors_sq += float((per_trial.astype(float) ** 2).sum())
        trials += batch
        chunk_idx += 1
        if block_errors >= cfg.max_block_errors:
            stopped_by = "block_errors"
            break
        if time.time() - start > cfg.max_seconds:
            stopped_by = "wall_clock"
            break
    elapsed = time.time() - start
    return SimulationResult(
        config=cfg, num_trials=trials,
        error_rate_per_iteration=[],
        block_error_rate=block_errors / trials,
        bit_error_rate=bit_errors / (cfg.n * trials),
        block_errors=block_errors, bit_errors=bit_errors,
        bit_errors_sq=bit_errors_sq,
        elapsed_seconds=elapsed,
        timestamp=datetime.now().strftime("%d-%m-%Y-%H-%M-%S"),
        stopped_by=stopped_by)


def run_simulation(cfg: SimulationConfig, code: Optional[LDPCCode] = None,
                   mesh: Optional[Mesh] = None,
                   use_all_devices: bool = False) -> SimulationResult:
    """Run the Monte Carlo to the reference's stopping rules and reduce.

    The host loop is the replacement for the reference's per-trial while
    loop (parallel_simulator.py:198): each iteration launches one jitted
    chunk of ``cfg.batch`` trials, accumulates host-side counters, and
    checks the three stopping rules at chunk granularity.
    """
    from ..models.qc import IrregularQCLDPCCode, QCLDPCCode

    if isinstance(code, (QCLDPCCode,
                         IrregularQCLDPCCode)) and cfg.decoder in (
            "ml", "both", "peeling"):
        code = code.expand()   # host drivers take edge-list codes
    if cfg.decoder in ("ml", "both"):
        return _run_ml_or_both(cfg, code)
    if cfg.decoder == "peeling":
        return _run_peeling(cfg, code)
    if mesh is None and (cfg.edge_sharded or use_all_devices) \
            and len(jax.devices()) > 1:
        mesh = make_mesh()
    if cfg.edge_sharded:
        if code is None:
            raise ValueError("edge_sharded requires a fixed code")
        if mesh is None:
            mesh = make_mesh(jax.devices()[:1])
        chunk_fn = make_edge_sharded_chunk_fn(cfg, code, mesh)
    else:
        chunk_fn = make_chunk_fn(cfg, code, mesh)
    key = jax.random.key(cfg.seed)

    # Multi-host: the counter-based stopping rules agree everywhere (the
    # psum'd totals are replicated), but the wall clock is per-process --
    # a divergent stop would strand the other processes in a collective.
    # Process 0's clock is authoritative, broadcast each chunk.
    multi_process = jax.process_count() > 1

    def wall_clock_exceeded(elapsed: float) -> bool:
        hit = elapsed > cfg.max_seconds
        if multi_process:
            from jax.experimental import multihost_utils

            hit = bool(multihost_utils.broadcast_one_to_all(
                np.asarray(hit)))
        return hit

    start = time.time()
    trials = 0
    chunk_idx = 0
    error_totals = np.zeros(cfg.iterations + 1, np.int64)
    block_errors = bit_errors = excluded = 0
    bit_errors_sq = 0.0
    code_bit_errors_sq = 0.0
    cluster_ok = True
    trials_per_code = None
    if cfg.code_mode == "ensemble":
        n_dev = 1 if mesh is None else mesh.size
        trials_per_code = 32 * _ensemble_layout(cfg, n_dev)[1]
    stopped_by = "num_tests"

    # Resume from a counter snapshot: chunk keys are pure functions of
    # (seed, chunk_idx), so a resumed run is bit-identical to an
    # uninterrupted one.  Multi-host: only process 0 writes checkpoints,
    # so only process 0's view of the file is authoritative (it may live
    # on host-local disk) -- its resume state is broadcast so every
    # process starts at the same chunk_idx; a divergent start would
    # strand the others in the chunk collective.
    if cfg.checkpoint_path:
        if (not multi_process or jax.process_index() == 0) and \
                os.path.exists(cfg.checkpoint_path):
            with open(cfg.checkpoint_path) as f:
                ck = json.load(f)
            if ck["seed"] == cfg.seed and ck["batch"] == cfg.batch:
                trials = ck["trials"]
                chunk_idx = ck["chunk_idx"]
                error_totals = np.asarray(ck["error_totals"], np.int64)
                block_errors = ck["block_errors"]
                bit_errors = ck["bit_errors"]
                excluded = ck["excluded"]
                bit_errors_sq = ck.get("bit_errors_sq", 0.0)
                code_bit_errors_sq = ck.get("code_bit_errors_sq", 0.0)
                # the cluster moment is only meaningful if the whole run
                # accumulated it at one cluster size: a checkpoint
                # predating the field, or written under a different
                # device count (different words-per-code), invalidates it
                if cfg.code_mode == "ensemble" and (
                        "code_bit_errors_sq" not in ck
                        or ck.get("trials_per_code") != trials_per_code):
                    cluster_ok = False
        if multi_process:
            from jax.experimental import multihost_utils

            state = multihost_utils.broadcast_one_to_all((
                np.asarray([trials, chunk_idx, block_errors, bit_errors,
                            excluded], np.int64),
                error_totals,
                np.asarray([bit_errors_sq, code_bit_errors_sq,
                            1.0 if cluster_ok else 0.0], np.float64)))
            (trials, chunk_idx, block_errors,
             bit_errors, excluded) = (int(x) for x in state[0])
            error_totals = np.asarray(state[1], np.int64)
            bit_errors_sq = float(state[2][0])
            code_bit_errors_sq = float(state[2][1])
            cluster_ok = state[2][2] > 0.5

    def write_checkpoint():
        tmp = cfg.checkpoint_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(dict(seed=cfg.seed, batch=cfg.batch, trials=trials,
                           chunk_idx=chunk_idx,
                           error_totals=error_totals.tolist(),
                           block_errors=block_errors,
                           bit_errors=bit_errors, excluded=excluded,
                           bit_errors_sq=bit_errors_sq,
                           code_bit_errors_sq=code_bit_errors_sq,
                           trials_per_code=trials_per_code), f)
        os.replace(tmp, cfg.checkpoint_path)

    while trials < cfg.num_tests:
        stats = chunk_fn(jax.random.fold_in(key, chunk_idx))
        stats = jax.device_get(stats)
        error_totals += np.asarray(stats.error_totals, np.int64)
        block_errors += int(stats.block_errors)
        bit_errors += int(stats.bit_errors)
        excluded += int(stats.excluded)
        bit_errors_sq += float(stats.bit_errors_sq)
        if stats.code_bit_errors_sq is not None:
            code_bit_errors_sq += float(stats.code_bit_errors_sq)
        trials += cfg.batch
        chunk_idx += 1
        if cfg.checkpoint_path and not (multi_process
                                        and jax.process_index() != 0) and \
                chunk_idx % cfg.checkpoint_every_chunks == 0:
            write_checkpoint()
        if block_errors >= cfg.max_block_errors:
            stopped_by = "block_errors"
            break
        if wall_clock_exceeded(time.time() - start):
            stopped_by = "wall_clock"
            break
    if cfg.checkpoint_path and not (multi_process
                                    and jax.process_index() != 0):
        write_checkpoint()

    elapsed = time.time() - start
    denom = cfg.n * trials
    return SimulationResult(
        config=cfg,
        num_trials=trials,
        error_rate_per_iteration=(error_totals / denom).tolist(),
        block_error_rate=block_errors / trials,
        bit_error_rate=bit_errors / denom,
        block_errors=block_errors,
        bit_errors=bit_errors,
        error_counts_per_iteration=error_totals.tolist(),
        excluded_trials=excluded,
        bit_errors_sq=bit_errors_sq,
        code_bit_errors_sq=(code_bit_errors_sq
                            if cfg.code_mode == "ensemble" and cluster_ok
                            else None),
        trials_per_code=trials_per_code if cluster_ok else None,
        elapsed_seconds=elapsed,
        timestamp=datetime.now().strftime("%d-%m-%Y-%H-%M-%S"),
        stopped_by=stopped_by,
    )
