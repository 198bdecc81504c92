"""QC roll decoder vs generic gather decoder, same codes, one GPU.

The motivating case is huge n, where the generic decoder is
gather-locality-bound and relabeling provably can't help.  The QC decoder
replaces every gather with a static-shift roll (stream traffic), so its
throughput should be set by bandwidth, not index locality.

Decode-only timing on fixed inputs (the headline convention), 50-iter
budget, eps=0.42, identical erased planes for both decoders (the QC
code IS the code the generic decoder runs, via expand()).

Run (GPU): python examples/bench_qc.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import jax
    import jax.numpy as jnp


    from iib_project_ldpc_codes_tpu.models.qc import sample_qc_code
    from iib_project_ldpc_codes_tpu.ops.channels import bec_packed_channel
    from iib_project_ldpc_codes_tpu.ops.erasure_bp import (
        bp_decode_packed_allzero)
    from iib_project_ldpc_codes_tpu.ops.qc_bp import (
        qc_bp_decode_packed_allzero)

    iters, eps = 50, 0.42
    for Z, words in [(834, 768), (8334, 512), (83334, 48)]:
        qc = sample_qc_code(jax.random.key(0), nb=12, dv=3, dc=6, Z=Z)
        n = qc.n
        code = qc.expand()
        erased = bec_packed_channel(jax.random.key(1), eps, (n, words))
        print(f"n={n} (Z={Z}) words={words}:", flush=True)
        for tag, fn in [
            ("generic", jax.jit(lambda e: bp_decode_packed_allzero(
                code, e, iters).error_totals)),
            ("qc-roll", jax.jit(lambda e: qc_bp_decode_packed_allzero(
                qc, e, iters).error_totals)),
        ]:
            t = time.time()
            out = fn(erased)
            jax.block_until_ready(out)
            tc = time.time() - t
            reps = 3
            t = time.perf_counter()
            for _ in range(reps):
                out = fn(erased)
            jax.block_until_ready(out)
            dt = (time.perf_counter() - t) / reps
            rate = (n // 2) * 32 * words / dt
            print(f"  {tag}: compile={tc:5.1f}s {dt * 1e3:8.1f} ms -> "
                  f"{rate / 1e9:.2f} Ginfobit/s", flush=True)
        a = np.asarray(qc_bp_decode_packed_allzero(
            qc, erased, iters).error_totals)
        b = np.asarray(bp_decode_packed_allzero(
            code, erased, iters).error_totals)
        assert (a == b).all(), "bit-exactness violated on the device"
        print("  trajectories bit-identical on the device", flush=True)
    print("DONE", flush=True)


if __name__ == "__main__":
    main()
