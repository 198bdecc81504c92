"""Throughput of the packed irregular erasure-BP decode on one GPU.

The irregular counterpart of bench.py's headline: the rate-1/2
(lambda, rho) = ((1/3)x + (2/3)x^3, x^5) ensemble at n ~ 10^4, 50
iterations, eps = 0.42, all-zero-codeword packed batches.  Phantom
padding makes the hot loop identical to the regular kernel at
E_pad/E = dv_max/avg_dv = 4/3 the variable-side gather traffic, so the
expected number is ~0.7-0.8x the regular headline per info bit
(same k = n/2).

Run from the repo root (GPU): python examples/bench_irregular.py
"""

import sys
import time

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp
import numpy as np


from iib_project_ldpc_codes_tpu.models.irregular import IrregularEnsembleSpec
from iib_project_ldpc_codes_tpu.ops.bitops import bernoulli_packed
from iib_project_ldpc_codes_tpu.ops.erasure_bp import (
    bp_decode_packed_allzero_irregular)

LAM = [0, 1 / 3, 0, 2 / 3]
RHO = [0, 0, 0, 0, 0, 1.0]
n, iters, eps = 10_000, 50, 0.42

spec = IrregularEnsembleSpec.from_lam_rho(n, LAM, RHO)
code = spec.sample(jax.random.key(0))
k = code.k
print(f"n={n} m={spec.m} k={k} dv_max={spec.dv_max} E={spec.E}",
      flush=True)

for words in (512, 768, 1024):
    erased = bernoulli_packed(jax.random.key(1), eps, (n, words))
    res = bp_decode_packed_allzero_irregular(code, erased, iters)
    jax.block_until_ready(res.known)
    reps = 6
    t = time.perf_counter()
    for r in range(reps):
        erased = bernoulli_packed(jax.random.key(2 + r), eps, (n, words))
        res = bp_decode_packed_allzero_irregular(code, erased, iters)
    jax.block_until_ready(res.known)
    dt = (time.perf_counter() - t) / reps
    trials = 32 * words
    rate = k * trials / dt
    print(f"words={words}: {dt*1e3:7.2f} ms/batch -> "
          f"{rate/1e9:.3f} Ginfobit/s", flush=True)
print("DONE", flush=True)
