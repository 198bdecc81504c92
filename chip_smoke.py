"""Chip smoke test: the Monte Carlo engine's main path on NVIDIA GPUs.

Run from the repository root:

    python chip_smoke.py               # phases P1-P7 on one card
    python chip_smoke.py --four-cards  # the batch- and edge-sharded paths
                                       # on four cards, and nothing else

Every phase drives the path users call (``SimulationConfig`` /
``run_simulation``; P7 goes through ``cli.main``) at the repository's own
headline and BASELINE sizes, times it on the card, and compares what came
out with a reference:

* the same computation on the host's CPU device.  The packed BEC and BSC
  decoders and the int8 decoder are integer arithmetic, and the channel
  draws are threefry bits, which do not depend on the platform, so those
  comparisons are bit-identical.  The float32 sum-product decoder is held
  to a stated tolerance instead (see :func:`p5_soft`);
* for quasi-cyclic codes, the generic gather decoder on ``code.expand()``
  on the same card (bit-identical, the contract of tests/test_qc.py);
* with ``--four-cards``, the same work on one card at a time.

Each phase prints one ``PHASE {...}`` line: its configuration, compile and
wall seconds, trials/s, the comparison and the card (``nvidia-smi`` name
and power limit).  A failed phase or comparison makes the script exit
non-zero without the final line.  The last line of a passing run is one
JSON object naming the devices JAX used.  The script exits non-zero at
once when JAX finds no GPU: it never runs the phases on the CPU alone.

Timings are of one cold process: each phase's first call compiles (or
loads from the persistent compile cache, utils/runtime.py), and its
steady window is ``Sizes.chunks`` further chunks through the same
executable.  One window per phase, no repetition: a smoke test of the
main path, not a benchmark.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import math
import os
import sys
import tempfile
import time
import traceback


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Problem sizes of every phase.  ``FULL`` is what the card runs;
    the test suite runs ``TOY`` on the CPU."""

    chunks: int = 20              # chunks in each phase's timed window
    head_n: int = 10_000          # P1: BEC (3,6) headline
    head_words: int = 768
    ens_n: int = 1_024            # P2: reference mode 0, fresh codes
    ens_batch: int = 8_192
    irr_n: int = 10_000           # P3: irregular (lambda, rho)
    irr_words: int = 512
    gal_n: int = 4_096            # P4: BASELINE config 2
    gal_batch: int = 8_192
    soft_n: int = 8_192           # P5: BASELINE config 3
    soft_batch: int = 2_048
    qc_huge_z: int = 83_334       # P6: n = 12 * Z ~ 1e6
    qc_huge_words: int = 48
    qc_cpu_words: int = 2
    qc_z: int = 8_334             # P6: QC Gallager and int8 soft
    qc_words: int = 64
    qc_soft_batch: int = 512
    cli_n: int = 512              # P7: reference mode 2 through the CLI
    cli_tests: int = 512
    edge_n: int = 1_000_000       # four cards: edge-sharded decode
    edge_words: int = 32
    check_rates: bool = True      # FER windows hold only at full size


FULL = Sizes()
TOY = Sizes(chunks=2, head_n=96, head_words=2, ens_n=96, ens_batch=128,
            irr_n=192, irr_words=2, gal_n=96, gal_batch=64, soft_n=96,
            soft_batch=64, qc_huge_z=16, qc_huge_words=2, qc_cpu_words=1,
            qc_z=8, qc_words=2, qc_soft_batch=64, cli_n=96, cli_tests=64,
            edge_n=192, edge_words=2, check_rates=False)

ITERS = 50
EPS = 0.42              # BEC erasure probability (threshold 0.4294)
BSC_P = 0.03            # BSC crossover (Gallager-A threshold ~0.0394)
AWGN_SIGMA = 0.86       # AWGN noise std (sum-product threshold ~0.881)
LAM = [0, 1 / 3, 0, 2 / 3]
RHO = [0, 0, 0, 0, 0, 1.0]


class SmokeFailure(Exception):
    """A comparison or a sanity window did not hold."""


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def _cfg(**kw):
    from iib_project_ldpc_codes_tpu.utils.config import SimulationConfig

    kw.setdefault("iterations", ITERS)
    kw.setdefault("max_block_errors", 10**9)
    kw.setdefault("num_tests", kw["batch"])
    return SimulationConfig(**kw)


def _simulate(cfg, code, device, mesh=None):
    """``run_simulation`` with the code and every key on ``device``;
    returns (result, seconds).  The code is committed to the device
    explicitly: a default-device block alone leaves committed arrays
    where they are."""
    import jax

    from iib_project_ldpc_codes_tpu.parallel.montecarlo import run_simulation

    with jax.default_device(device):
        if code is not None and mesh is None:
            code = jax.device_put(code, device)
        start = time.perf_counter()
        res = run_simulation(cfg, code=code, mesh=mesh)
        return res, time.perf_counter() - start


def _counters(res) -> dict:
    return {"trials": res.num_trials,
            "per_iteration": list(res.error_counts_per_iteration),
            "block_errors": res.block_errors, "bit_errors": res.bit_errors,
            "excluded": res.excluded_trials}


def _same(a, b, what: str) -> str:
    ca, cb = _counters(a), _counters(b)
    diff = [k for k in ca if ca[k] != cb[k]]
    _check(not diff, f"{what}: counters differ in {diff}: "
           f"{ {k: (ca[k], cb[k]) for k in diff} }")
    return f"bit-identical to {what}"


def _timed_run(cfg, code, device, chunks: int, mesh=None) -> dict:
    """First call (compile + chunk 0) and a steady ``chunks``-chunk run;
    returns both results and the derived timings."""
    first, t_first = _simulate(cfg, code, device, mesh)
    steady_cfg = dataclasses.replace(cfg, num_tests=chunks * cfg.batch)
    steady, t_steady = _simulate(steady_cfg, code, device, mesh)
    return {"first": first, "steady": steady,
            "compile_s": max(t_first - t_steady / chunks, 0.0),
            "wall_s": t_steady,
            "trials_per_s": steady.num_trials / t_steady}


def _record(config: str, run: dict, compare: str, **extra) -> dict:
    return {"config": config, "compile_s": run["compile_s"],
            "wall_s": run["wall_s"], "trials_per_s": run["trials_per_s"],
            "fer": run["steady"].block_error_rate, "compare": compare,
            **extra}


# --------------------------------------------------------------------------
# One-card phases: fn(devices, ref, sizes) -> record.  devices[0] is the
# device under test, ref the comparison device.
# --------------------------------------------------------------------------

def p1_headline(devices, ref, sz: Sizes) -> dict:
    import jax

    from iib_project_ldpc_codes_tpu.models import sample_code

    dev = devices[0]
    cfg = _cfg(channel="BEC", channel_param=EPS, n=sz.head_n, dv=3, dc=6,
               decoder="bp", batch=32 * sz.head_words, code_mode="fixed",
               seed=1)
    code = sample_code(jax.random.key(0), cfg.n, 3, 6)
    run = _timed_run(cfg, code, dev, sz.chunks)
    cpu, _ = _simulate(cfg, code, ref)
    compare = _same(run["first"], cpu, "chunk 0 on the CPU device")
    fer = run["steady"].block_error_rate
    if sz.check_rates:
        _check(0.05 < fer < 0.3, f"headline FER {fer} outside (0.05, 0.3)")
    return _record(
        f"BEC (3,6) fixed n={cfg.n} eps={EPS} iters={ITERS} "
        f"batch={cfg.batch} chunks={sz.chunks}", run, compare,
        info_bits_per_s=run["trials_per_s"] * cfg.k)


def p2_ensemble(devices, ref, sz: Sizes) -> dict:
    cfg = _cfg(channel="BEC", channel_param=EPS, n=sz.ens_n, dv=3, dc=6,
               decoder="bp", batch=sz.ens_batch, code_mode="ensemble",
               seed=2)
    run = _timed_run(cfg, None, devices[0], sz.chunks)
    cpu, _ = _simulate(cfg, None, ref)
    return _record(
        f"BEC (3,6) ensemble n={cfg.n} eps={EPS} batch={cfg.batch} "
        f"codes/chunk={cfg.codes_per_chunk}", run,
        _same(run["first"], cpu, "chunk 0 on the CPU device"))


def p3_irregular(devices, ref, sz: Sizes) -> dict:
    import jax

    from iib_project_ldpc_codes_tpu.models.irregular import (
        IrregularEnsembleSpec)

    cfg = _cfg(channel="BEC", channel_param=EPS, n=sz.irr_n, decoder="bp",
               lam=LAM, rho=RHO, batch=32 * sz.irr_words,
               code_mode="fixed", seed=3)
    code = IrregularEnsembleSpec.from_lam_rho(cfg.n, LAM, RHO).sample(
        jax.random.key(3))
    run = _timed_run(cfg, code, devices[0], sz.chunks)
    cpu, _ = _simulate(cfg, code, ref)
    return _record(
        f"BEC irregular lam=(1/3)x+(2/3)x^3 rho=x^5 n={cfg.n} eps={EPS} "
        f"batch={cfg.batch}", run,
        _same(run["first"], cpu, "chunk 0 on the CPU device"))


def p4_gallager(devices, ref, sz: Sizes) -> dict:
    import jax

    from iib_project_ldpc_codes_tpu.models import sample_code

    cfg = _cfg(channel="BSC", channel_param=BSC_P, n=sz.gal_n, dv=3, dc=6,
               decoder="gallager", batch=sz.gal_batch, code_mode="fixed",
               seed=4)
    code = sample_code(jax.random.key(4), cfg.n, 3, 6)
    run = _timed_run(cfg, code, devices[0], sz.chunks)
    cpu, _ = _simulate(cfg, code, ref)
    return _record(
        f"BSC Gallager-A (3,6) fixed n={cfg.n} p={BSC_P} batch={cfg.batch}",
        run, _same(run["first"], cpu, "chunk 0 on the CPU device"))


def p5_soft(devices, ref, sz: Sizes) -> dict:
    """AWGN soft decoding: int8 min-sum and float32 sum-product.

    The decoders are compared on ONE LLR array, drawn on the card and
    copied to the CPU device: the Gaussian draw's float transform may
    round differently on the two platforms, and a moved int8
    quantisation boundary would be a channel difference, not a decoder
    one.  int8 min-sum is integer arithmetic after quantisation, so its
    decisions must be bit-identical.  float32 sum-product is not: the
    GPU evaluates tanh/atanh with its own approximations and orders its
    fusions differently, so a trial near the decoding boundary can
    converge on one device and not the other.  It is held to at most
    0.5% of trials decided differently, and the card's FER must lie in
    the CPU FER's 95% binomial interval.
    """
    import jax
    import jax.numpy as jnp
    import numpy as np

    from iib_project_ldpc_codes_tpu.models import sample_code
    from iib_project_ldpc_codes_tpu.ops.channels import AWGN
    from iib_project_ldpc_codes_tpu.ops.soft_bp import soft_bp_decode

    dev = devices[0]
    n, batch = sz.soft_n, sz.soft_batch
    code = sample_code(jax.random.key(5), n, 3, 6)
    runs, compares = {}, []
    for method, dtype in (("minsum", "int8"), ("sumproduct", "float32")):
        cfg = _cfg(channel="AWGN", channel_param=AWGN_SIGMA, n=n, dv=3,
                   dc=6, decoder=method, soft_msg_dtype=dtype, batch=batch,
                   code_mode="fixed", seed=5)
        runs[dtype] = _timed_run(cfg, code, dev, sz.chunks)

    ch = AWGN(AWGN_SIGMA)
    with jax.default_device(dev):
        llr = jax.jit(lambda k: ch.llr(ch.transmit(
            k, jnp.zeros((n, batch), jnp.int32))))(jax.random.key(55))
    on_dev = (jax.device_put(code, dev), jax.device_put(llr, dev))
    on_ref = (jax.device_put(code, ref), jax.device_put(llr, ref))

    def decode(args, method, dtype):
        res = soft_bp_decode(*args, ITERS, method=method,
                             msg_dtype=jnp.dtype(dtype))
        return jax.device_get((res.hard, res.error_totals, res.iterations))

    a, b = decode(on_dev, "minsum", "int8"), decode(on_ref, "minsum", "int8")
    for name, x, y in zip(("decisions", "per-iteration errors",
                           "iterations"), a, b):
        _check(np.array_equal(x, y), f"int8 min-sum {name} differ from CPU")
    compares.append("int8: decisions bit-identical to the CPU device")

    a = decode(on_dev, "sumproduct", "float32")
    b = decode(on_ref, "sumproduct", "float32")
    fail_a, fail_b = a[0].any(axis=0), b[0].any(axis=0)
    differ = float(np.mean(fail_a != fail_b))
    fer_a, fer_b = float(fail_a.mean()), float(fail_b.mean())
    half = 1.96 * math.sqrt(max(fer_b * (1 - fer_b), 1.0 / batch) / batch)
    _check(differ <= 0.005, f"f32 sum-product: {differ:.4%} of trials "
           "decided differently from the CPU (limit 0.5%)")
    _check(abs(fer_a - fer_b) <= half, f"f32 sum-product FER {fer_a} "
           f"outside the CPU's 95% interval {fer_b} +- {half:.4g}")
    compares.append(f"f32: {differ:.4%} of trials decided differently "
                    f"(limit 0.5%), FER {fer_a:.4g} vs CPU {fer_b:.4g} "
                    f"+- {half:.3g}")
    head = runs["int8"]
    return _record(
        f"AWGN (3,6) fixed n={n} sigma={AWGN_SIGMA} batch={batch}: int8 "
        f"min-sum (timed) and f32 sum-product", head, "; ".join(compares),
        f32_trials_per_s=runs["float32"]["trials_per_s"],
        f32_compile_s=runs["float32"]["compile_s"],
        f32_fer=runs["float32"]["steady"].block_error_rate)


def p6_qc(devices, ref, sz: Sizes) -> dict:
    """Quasi-cyclic codes through make_chunk_fn's roll dispatch, against
    the generic gather decoder on expand() on the same card."""
    import jax

    from iib_project_ldpc_codes_tpu.models.qc import sample_qc_code

    dev = devices[0]
    qc = sample_qc_code(jax.random.key(6), nb=12, dv=3, dc=6,
                        Z=sz.qc_huge_z)
    cfg = _cfg(channel="BEC", channel_param=EPS, n=qc.n, dv=3, dc=6,
               decoder="bp", batch=32 * sz.qc_huge_words,
               code_mode="fixed", seed=6)
    run = _timed_run(cfg, qc, dev, sz.chunks)
    generic, t_generic = _simulate(cfg, qc.expand(), dev)
    compares = [_same(run["first"], generic, "the generic decoder")]

    small = dataclasses.replace(cfg, batch=32 * sz.qc_cpu_words,
                                num_tests=32 * sz.qc_cpu_words)
    on_dev, _ = _simulate(small, qc, dev)
    on_ref, _ = _simulate(small, qc, ref)
    compares.append(_same(on_dev, on_ref,
                          f"the CPU device at {sz.qc_cpu_words} words"))

    extra = {"generic_first_call_s": t_generic}
    qc_small = sample_qc_code(jax.random.key(7), nb=12, dv=3, dc=6,
                              Z=sz.qc_z)
    for label, kw in (
            ("gallager", dict(channel="BSC", channel_param=BSC_P,
                              decoder="gallager",
                              batch=32 * sz.qc_words)),
            ("int8 soft", dict(channel="AWGN", channel_param=AWGN_SIGMA,
                               decoder="minsum", soft_msg_dtype="int8",
                               batch=sz.qc_soft_batch))):
        c = _cfg(n=qc_small.n, dv=3, dc=6, code_mode="fixed", seed=7, **kw)
        roll, t_roll = _simulate(c, qc_small, dev)
        gen, _ = _simulate(c, qc_small.expand(), dev)
        compares.append(f"{label} n={c.n}: " + _same(roll, gen,
                                                     "the generic decoder"))
        extra[f"{label.replace(' ', '_')}_first_call_s"] = t_roll
    return _record(
        f"QC nb=12 (3,6) BEC Z={sz.qc_huge_z} n={qc.n} eps={EPS} "
        f"batch={cfg.batch}; Gallager and int8 soft at Z={sz.qc_z}", run,
        "; ".join(compares), **extra)


def p7_cli(devices, ref, sz: Sizes) -> dict:
    """Reference mode 2 (ML and BP on the same channel outputs) through
    the CLI.  ML is optimal, so BP can fail no trial that ML decodes."""
    from iib_project_ldpc_codes_tpu import cli
    from iib_project_ldpc_codes_tpu.utils.results import load_result

    platform = "gpu" if devices[0].platform == "gpu" else "cpu"
    with tempfile.TemporaryDirectory() as out:
        argv = [str(EPS), str(sz.cli_tests), str(ITERS), str(sz.cli_n),
                "3", "6", "2", "7", f"--platform={platform}",
                f"--output-dir={out}"]
        start = time.perf_counter()
        rc = cli.main(argv)
        wall = time.perf_counter() - start
        _check(rc == 0, f"cli.main returned {rc}")
        files = glob.glob(os.path.join(out, "*.json"))
        _check(len(files) == 1, f"cli wrote {files}")
        res = load_result(files[0])
    _check(res.num_trials >= sz.cli_tests, f"{res.num_trials} trials")
    _check(res.block_errors >= res.optimal_block_errors,
           f"BP block errors {res.block_errors} < ML "
           f"{res.optimal_block_errors}")
    return {"config": f"cli mode 2 (ML + BP, ensemble) n={sz.cli_n} "
                      f"eps={EPS} trials={res.num_trials} "
                      f"--platform={platform}",
            "compile_s": None, "wall_s": wall,
            "trials_per_s": res.num_trials / wall,
            "fer": res.block_error_rate,
            "compare": f"BP FER {res.block_error_rate:.4g} >= ML FER "
                       f"{res.optimal_block_error_rate:.4g}"}


# --------------------------------------------------------------------------
# Four-card phases: devices[:4] form the mesh, each card alone is the
# reference.
# --------------------------------------------------------------------------

def _on_four(devices, out) -> str:
    """Check that a mesh output's shards sit on four distinct devices."""
    placed = {s.device for s in out.addressable_shards}
    _check(placed == set(devices[:4]),
           f"shards on {sorted(str(d) for d in placed)}, not on the four "
           "mesh devices")
    return "shards on 4 distinct devices"


def f1_batch_sharded(devices, ref, sz: Sizes) -> dict:
    """P1's configuration with the batch sharded over four cards, against
    the sum of the four per-card chunks, each run alone with the key
    fold_in(chunk_key, idx) the mesh gives card idx."""
    import jax
    import numpy as np

    from iib_project_ldpc_codes_tpu.models import sample_code
    from iib_project_ldpc_codes_tpu.parallel.mesh import make_mesh
    from iib_project_ldpc_codes_tpu.parallel.montecarlo import make_chunk_fn

    _check(len(devices) >= 4, f"need 4 devices, have {len(devices)}")
    mesh = make_mesh(devices[:4])
    per_card = 32 * sz.head_words
    cfg4 = _cfg(channel="BEC", channel_param=EPS, n=sz.head_n, dv=3, dc=6,
                decoder="bp", batch=4 * per_card, code_mode="fixed", seed=1)
    code = sample_code(jax.random.key(0), cfg4.n, 3, 6)
    run = _timed_run(cfg4, code, devices[0], sz.chunks, mesh=mesh)

    chunk_key = jax.random.fold_in(jax.random.key(cfg4.seed), 0)
    placed = _on_four(devices, make_chunk_fn(cfg4, code, mesh)(
        chunk_key).error_totals)
    cfg1 = dataclasses.replace(cfg4, batch=per_card, num_tests=per_card)
    totals, block, bit = np.zeros(ITERS + 1, np.int64), 0, 0
    for idx, d in enumerate(devices[:4]):
        stats = make_chunk_fn(cfg1, jax.device_put(code, d))(
            jax.device_put(jax.random.fold_in(chunk_key, idx), d))
        stats = jax.device_get(stats)
        totals += np.asarray(stats.error_totals, np.int64)
        block += int(stats.block_errors)
        bit += int(stats.bit_errors)
    mesh_c = _counters(run["first"])
    _check(mesh_c["per_iteration"] == totals.tolist()
           and mesh_c["block_errors"] == block
           and mesh_c["bit_errors"] == bit,
           f"4-card chunk {mesh_c} != per-card sum "
           f"({totals.tolist()}, {block}, {bit})")
    return _record(
        f"BEC (3,6) fixed n={cfg4.n} eps={EPS} batch=4x{per_card} on a "
        f"4-card mesh, chunks={sz.chunks}", run,
        f"bit-identical to the sum of 4 one-card chunks; {placed}",
        info_bits_per_s=run["trials_per_s"] * cfg4.k)


def f2_edge_sharded(devices, ref, sz: Sizes) -> dict:
    """edge_sharded_bp_decode on four cards against
    bp_decode_packed_allzero on one card (the module's contract:
    bit-identical), and the edge-sharded Monte Carlo chunk against the
    unsharded one."""
    import jax
    import numpy as np

    from iib_project_ldpc_codes_tpu.models import sample_code
    from iib_project_ldpc_codes_tpu.ops.channels import bec_packed_channel
    from iib_project_ldpc_codes_tpu.ops.erasure_bp import (
        bp_decode_packed_allzero)
    from iib_project_ldpc_codes_tpu.parallel.edge_sharded import (
        edge_sharded_bp_decode)
    from iib_project_ldpc_codes_tpu.parallel.mesh import make_mesh

    _check(len(devices) >= 4, f"need 4 devices, have {len(devices)}")
    mesh = make_mesh(devices[:4])
    n, words = sz.edge_n, sz.edge_words
    code = sample_code(jax.random.key(8), n, 3, 6)
    # drawn inside jit: outside it the [n, 32 W] raw bits materialise
    erased = jax.jit(lambda k: bec_packed_channel(k, EPS, (n, words)))(
        jax.random.key(9))

    start = time.perf_counter()
    sharded = jax.block_until_ready(
        edge_sharded_bp_decode(code, erased, ITERS, mesh))
    t_sharded = time.perf_counter() - start
    placed = _on_four(devices, sharded.known)
    start = time.perf_counter()
    single = jax.block_until_ready(bp_decode_packed_allzero(
        jax.device_put(code, devices[0]),
        jax.device_put(erased, devices[0]), ITERS))
    t_single = time.perf_counter() - start
    for name in ("known", "error_totals", "iterations"):
        _check(np.array_equal(jax.device_get(getattr(sharded, name)),
                              jax.device_get(getattr(single, name))),
               f"edge-sharded {name} differs from the one-card decode")

    cfg = _cfg(channel="BEC", channel_param=EPS, n=n, dv=3, dc=6,
               decoder="bp", batch=32 * words, code_mode="fixed",
               edge_sharded=True, seed=8)
    run = _timed_run(cfg, code, devices[0], sz.chunks, mesh=mesh)
    plain, _ = _simulate(dataclasses.replace(cfg, edge_sharded=False),
                         code, devices[0])
    compare = (f"decode bit-identical to one card; {placed}; chunk "
               + _same(run["first"], plain, "the unsharded chunk"))
    return _record(
        f"edge-sharded BEC (3,6) n={n} eps={EPS} batch={cfg.batch} on a "
        "4-card mesh", run, compare, decode_first_call_s=t_sharded,
        one_card_first_call_s=t_single)


PHASES = [("P1 headline", p1_headline), ("P2 ensemble", p2_ensemble),
          ("P3 irregular", p3_irregular), ("P4 gallager", p4_gallager),
          ("P5 soft", p5_soft), ("P6 qc", p6_qc), ("P7 cli", p7_cli)]
FOUR_CARD_PHASES = [("F1 batch-sharded", f1_batch_sharded),
                    ("F2 edge-sharded", f2_edge_sharded)]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    unknown = [a for a in argv if a != "--four-cards"]
    if unknown:
        print(__doc__)
        return 2
    four = "--four-cards" in argv

    import jax

    from iib_project_ldpc_codes_tpu.utils.runtime import (
        enable_compile_cache, gpu_name_and_power_limit, require_gpu)

    # CUDA first, so the card is the default device; the CPU backend is
    # kept as the comparison device.
    jax.config.update("jax_platforms", "cuda,cpu")
    enable_compile_cache()
    info = require_gpu(jax.devices())
    card = gpu_name_and_power_limit()
    if card is None:
        raise SystemExit("nvidia-smi is unavailable: the card's name and "
                         "power limit cannot be reported")
    card = "; ".join(card.splitlines())
    print(f"card: {card}", flush=True)
    print(f"jax {jax.__version__}: platform={info['platform']} "
          f"device_kind={info['kind']} device_count={info['count']}",
          flush=True)

    devices, ref = jax.devices(), jax.devices("cpu")[0]
    failed = []
    for name, phase in FOUR_CARD_PHASES if four else PHASES:
        try:
            record = phase(devices, ref, FULL)
        except Exception:  # report every phase, then fail the run
            traceback.print_exc()
            print(f"PHASE {name} FAILED", flush=True)
            failed.append(name)
            continue
        print("PHASE " + json.dumps({"phase": name, **record,
                                     "card": card}), flush=True)
    if failed:
        print(f"failed phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
