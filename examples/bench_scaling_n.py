"""Headline-kernel throughput vs block length n (decode-only, one GPU).

Is the packed BEC BP kernel's bandwidth-bound throughput flat in n?
Per decoded bit the kernel moves a constant number of bytes (6 check
gathers + 3 variable gathers per edge, fixed degree), so if the
gathers stay at stream rate the info-bit rate should be ~constant from
n=1e3 to n=1e6 at a constant total-bits batch.  Deviations localise
where the working set outgrows a cache level or the batch width drops
below the lane-efficiency knee.

Constant total batch: words(n) = round(7.68e6 / n) -- the n=1e4
headline's n*W product (768 words) -- so every point decodes the same
~245 Mbit per call.  50-iteration budget, eps=0.42, allzero kernel
(the bench.py headline's exact convention).  Persists to
docs/data/throughput_vs_n.json (resumable).

Run (GPU, background): python examples/bench_scaling_n.py
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "docs", "data", "throughput_vs_n.json")


def main():
    import jax
    import jax.numpy as jnp
    import numpy as np


    from iib_project_ldpc_codes_tpu.models import sample_code
    from iib_project_ldpc_codes_tpu.ops.channels import bec_packed_channel
    from iib_project_ldpc_codes_tpu.ops.erasure_bp import (
        bp_decode_packed_allzero)

    doc = {}
    if os.path.exists(DATA):
        with open(DATA) as f:
            doc = json.load(f)

    iters, eps = 50, 0.42
    # constant-total-bits points (words = 7.68e6/n) PLUS wide-batch
    # points at large n that hold words near the lane-efficiency knee
    # measured at n=1e4 -- disentangling the n-effect from the words
    # (batch-width) effect.  Widths are capped by the exact-int32
    # counter contract (n * words * 32 < 2^31, ops/erasure_bp
    # ._check_packed_batch_bits): 512 at n=1e5, 48 at n=1e6.
    points = [(1_000, 7_680), (10_000, 768), (100_000, 77),
              (100_000, 512), (1_000_000, 8), (1_000_000, 48)]
    for n, words in points:
        key = f"{n}_{words}"
        legacy = str(n)
        if legacy in doc and doc[legacy]["words"] == words:
            doc[key] = doc.pop(legacy)
        if key in doc:
            print(f"n={n} w={words}: cached "
                  f"{doc[key]['ginfobit_s']:.2f}", flush=True)
            continue
        if (n * 3) % 6:
            raise ValueError(n)
        code = sample_code(jax.random.key(0), n, 3, 6)
        erased = bec_packed_channel(jax.random.key(1), eps, (n, words))
        fn = jax.jit(lambda e: bp_decode_packed_allzero(
            code, e, iters).error_totals)
        t = time.time()
        out = fn(erased)
        jax.block_until_ready(out)
        tc = time.time() - t
        reps = 5
        t = time.perf_counter()
        for _ in range(reps):
            out = fn(erased)
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t) / reps
        k = n // 2
        rate = k * 32 * words / dt
        res = bp_decode_packed_allzero(code, erased, iters)
        doc[key] = dict(n=n, words=words, compile_s=round(tc, 1),
                        ms_per_call=round(dt * 1e3, 2),
                        ginfobit_s=round(rate / 1e9, 3),
                        iterations=int(res.iterations),
                        fer=float(np.asarray(res.failed).mean()))
        os.makedirs(os.path.dirname(DATA), exist_ok=True)
        with open(DATA + ".tmp", "w") as f:
            json.dump(doc, f, indent=1)
        os.replace(DATA + ".tmp", DATA)
        print(f"n={n}: words={words} compile={tc:.0f}s "
              f"{dt * 1e3:.1f} ms -> {rate / 1e9:.2f} Ginfobit/s "
              f"(iters={doc[key]['iterations']}, "
              f"FER={doc[key]['fer']:.3f})", flush=True)
    print("DONE", flush=True)


if __name__ == "__main__":
    main()
