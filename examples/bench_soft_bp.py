"""Soft-BP throughput benchmark on one GPU (check-resident kernel).

Measures decoded info bits/s for the AWGN n=8192 workload (BASELINE.json
config 3) across message dtypes (f32 / bf16 / int8 quantised min-sum) and
batch widths, 50 iterations.  Run from the repo root:

    python examples/bench_soft_bp.py
"""
import sys
import time

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp
import numpy as np


from iib_project_ldpc_codes_tpu.models import sample_code
from iib_project_ldpc_codes_tpu.ops.channels import AWGN
from iib_project_ldpc_codes_tpu.ops.soft_bp import soft_bp_decode

n, dv, dc, iters = 8192, 3, 6, 50
k = n // 2
code = sample_code(jax.random.key(0), n, dv, dc)
ch = AWGN(AWGN.sigma_from_ebn0_db(1.5, 0.5))


def bench(method, dtype, B, reps=3):
    y = ch.transmit(jax.random.key(1), jnp.zeros((n, B), jnp.int32))
    llr = ch.llr(y)
    fn = jax.jit(lambda llr: soft_bp_decode(
        code, llr, iters, method=method, msg_dtype=dtype).error_totals)
    t0 = time.time()
    out = fn(llr); jax.block_until_ready(out)
    tc = time.time() - t0
    t = time.perf_counter()
    for _ in range(reps):
        out = fn(llr)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t) / reps
    gbps = k * B / dt / 1e9
    name = {jnp.bfloat16: "bf16", jnp.int8: "int8"}.get(
        dtype, np.dtype(dtype).name)
    print(f"{method:10s} {name:8s} B={B:5d} compile={tc:5.1f}s "
          f"{dt*1e3:8.1f} ms  {gbps:.4f} Ginfobit/s", flush=True)
    return gbps


bench("sumproduct", jnp.float32, 1024)
bench("sumproduct", jnp.bfloat16, 1024)
bench("minsum", jnp.bfloat16, 1024)
bench("minsum", jnp.int8, 1024)
bench("minsum", jnp.int8, 2048)
bench("minsum", jnp.int8, 3072)
bench("sumproduct", jnp.bfloat16, 2048)
print("DONE", flush=True)
