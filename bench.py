"""Headline benchmark: decoded information bits/s on one GPU.

Config per BASELINE.md north star: (3,6)-regular LDPC, n = 10^4, 50 BP
iterations, BEC near threshold (eps = 0.42), bit-packed batched erasure BP.
Throughput counts k = n/2 information bits per decoded trial, decode time
only (channel generation excluded, matching the reference's C-decoder-only
hot loop).  Target: >= 1e9 info bits/s/chip (vs_baseline = value / 1e9).

The one JSON line also carries regression tripwires for three secondary
workloads, each decode-only on a fixed input like the headline:

  * ``soft_int8_bits_s``  -- int8 quantised min-sum, AWGN n=8192,
    50 iterations, B=2048;
  * ``irregular_bits_s``  -- packed irregular erasure BP, rate-1/2
    (lambda, rho) = ((1/3)x + (2/3)x^3, x^5) at n = 10^4, eps = 0.42,
    words=512;
  * ``qc_n1e6_bits_s`` -- the quasi-cyclic roll decoder at n ~ 1e6
    (Z=83334 lift, words=48).

The batch widths are plain parameters; they have not been tuned on the
GPU.  Every record names the devices it ran on; outside ``--dry`` the
script refuses to run anywhere but on a GPU.

Flags:
  --dry        tiny CPU run (pipeline/CI check, ~seconds; still one JSON
               line, marked as a CPU dry run -- its rates are no device's)
  --spread=N   repeat the timed measurement N times and add best/worst/mean
               fields to the JSON line (the headline "value" = mean)
  --headline-only   skip the secondary tripwires (fast iteration)
"""

import json
import sys
import time


def _timed_rates(fn, arg, per_call_bits, reps, spread):
    """Compile + time ``fn(arg)``; returns a list of spread bit-rates."""
    import jax

    out = fn(arg)
    jax.block_until_ready(out)        # compile
    rates = []
    for _ in range(spread):
        start = time.perf_counter()
        for _ in range(reps):
            out = fn(arg)
        jax.block_until_ready(out)
        rates.append(per_call_bits / ((time.perf_counter() - start) / reps))
    return rates


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    dry = "--dry" in argv
    headline_only = "--headline-only" in argv
    spread = 1
    for a in argv:
        if a.startswith("--spread="):
            spread = max(1, int(a.split("=", 1)[1]))

    import jax

    from iib_project_ldpc_codes_tpu.utils.runtime import (
        device_info, enable_compile_cache, gpu_name_and_power_limit,
        require_gpu)

    enable_compile_cache()
    jax.config.update("jax_platforms", "cpu" if dry else "cuda")
    info = device_info() if dry else require_gpu()

    import jax.numpy as jnp

    from iib_project_ldpc_codes_tpu.models import sample_code
    from iib_project_ldpc_codes_tpu.ops.channels import bec_packed_channel
    from iib_project_ldpc_codes_tpu.ops.erasure_bp import (
        bp_decode_packed_allzero)

    n, dv, dc = 10_000, 3, 6
    iters = 50
    eps = 0.42
    words = 8 if dry else 768        # 24576 trials per decode call
    batch = words * 32
    k = n * (dc - dv) // dc

    code = sample_code(jax.random.key(0), n, dv, dc)
    erased = bec_packed_channel(jax.random.key(1), eps, (n, words))

    def run(erased):
        # all-zero-codeword transmit: the reference's Monte Carlo workload
        res = bp_decode_packed_allzero(code, erased, iters)
        return res.error_totals, res.iterations

    reps = 1 if dry else 5
    rates = _timed_rates(jax.jit(run), erased, k * batch, reps, spread)
    mean = sum(rates) / len(rates)
    record = {
        "metric": "decoded info bits/s/chip (n=1e4, 50 BP iters, eps=0.42)",
        "value": round(mean, 1),
        "unit": "bits/s",
        "vs_baseline": round(mean / 1e9, 4),
        "platform": info["platform"],
        "device_kind": info["kind"],
        "device_count": info["count"],
        "gpu": None if dry else gpu_name_and_power_limit(),
    }
    if spread > 1:
        record["spread_min"] = round(min(rates), 1)
        record["spread_max"] = round(max(rates), 1)
        record["spread_n"] = spread
    if dry:
        record["dry_run"] = "cpu"

    if not headline_only:
        # --- secondary tripwire 1: int8 min-sum (AWGN, n=8192, B=2048) ---
        from iib_project_ldpc_codes_tpu.ops.channels import AWGN
        from iib_project_ldpc_codes_tpu.ops.soft_bp import soft_bp_decode

        ns, Bs = (512, 64) if dry else (8192, 2048)
        soft_code = sample_code(jax.random.key(2), ns, 3, 6)
        ch = AWGN(AWGN.sigma_from_ebn0_db(1.5, 0.5))
        llr = ch.llr(ch.transmit(jax.random.key(3),
                                 jnp.zeros((ns, Bs), jnp.int32)))
        soft_fn = jax.jit(lambda llr: soft_bp_decode(
            soft_code, llr, iters, method="minsum",
            msg_dtype=jnp.int8).error_totals)
        soft_rates = _timed_rates(soft_fn, llr, (ns // 2) * Bs, reps, 1)
        record["soft_int8_bits_s"] = round(soft_rates[0], 1)

        # --- secondary tripwire 2: irregular packed BP (n=1e4, w=512) ---
        from iib_project_ldpc_codes_tpu.models.irregular import (
            IrregularEnsembleSpec)
        from iib_project_ldpc_codes_tpu.ops.erasure_bp import (
            bp_decode_packed_allzero_irregular)

        ni, wi = (500, 8) if dry else (10_000, 512)
        spec = IrregularEnsembleSpec.from_lam_rho(
            ni, [0, 1 / 3, 0, 2 / 3], [0, 0, 0, 0, 0, 1.0])
        irr_code = spec.sample(jax.random.key(4))
        irr_erased = bec_packed_channel(jax.random.key(5), eps, (ni, wi))
        irr_fn = jax.jit(lambda e: bp_decode_packed_allzero_irregular(
            irr_code, e, iters).error_totals)
        irr_rates = _timed_rates(irr_fn, irr_erased,
                                 irr_code.k * 32 * wi, reps, 1)
        record["irregular_bits_s"] = round(irr_rates[0], 1)

        # --- secondary tripwire 3: QC roll decoder at n ~ 1e6 ---------
        from iib_project_ldpc_codes_tpu.models.qc import sample_qc_code
        from iib_project_ldpc_codes_tpu.ops.qc_bp import (
            qc_bp_decode_packed_allzero)

        Zq, wq = (40, 4) if dry else (83334, 48)
        qc = sample_qc_code(jax.random.key(6), nb=12, dv=3, dc=6, Z=Zq)
        qc_erased = bec_packed_channel(jax.random.key(7), eps,
                                       (qc.n, wq))
        qc_fn = jax.jit(lambda e: qc_bp_decode_packed_allzero(
            qc, e, iters).error_totals)
        qc_rates = _timed_rates(qc_fn, qc_erased, (qc.n // 2) * 32 * wq,
                                reps, 1)
        record["qc_n1e6_bits_s"] = round(qc_rates[0], 1)

    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
