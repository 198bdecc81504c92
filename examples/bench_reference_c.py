"""Benchmark the REFERENCE's compiled C decoder at the headline workload.

Compiles /root/reference/message_passing.c (when the checkout is present)
and times it on the exact bench.py configuration -- (3,6)-regular,
n = 10^4, 50 BP iterations, BEC eps = 0.42 -- for a like-for-like
"reference info bits/s per CPU core" number to put next to the GPU
throughput.  The C decoder keeps its own early-exit/stall shortcuts
(message_passing.c:16-19, :76-78), so this is its best case.

Usage: python examples/bench_reference_c.py [trials]
"""

import ctypes
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, ".")

REFERENCE = os.environ.get("LDPC_REFERENCE", "/root/reference")


def main(trials: int = 200) -> int:
    src = os.path.join(REFERENCE, "message_passing.c")
    if not os.path.exists(src):
        print(f"reference checkout not found at {REFERENCE}")
        return 1

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from iib_project_ldpc_codes_tpu.models import sample_code
    from iib_project_ldpc_codes_tpu.ops import BEC

    with tempfile.TemporaryDirectory() as tmp:
        so = os.path.join(tmp, "message_passing.so")
        subprocess.run(["cc", "-O2", "-shared", "-fPIC", src, "-o", so],
                       check=True, capture_output=True)
        lib = ctypes.CDLL(so)
    lib.message_passing.restype = ctypes.c_int

    n, dv, dc, iters, eps = 10_000, 3, 6, 50, 0.42
    k = n // 2
    code = sample_code(jax.random.key(0), n, dv, dc)
    var_lookup = np.asarray(code.var_to_chk, np.int32).reshape(-1)
    chk_lookup = np.asarray(code.chk_to_var, np.int32).reshape(-1)
    rx = np.asarray(BEC(eps).transmit(jax.random.key(1),
                                      jnp.zeros((trials, n), jnp.int32)),
                    np.int32)
    errors = np.zeros(iters, np.int32)
    iptr = ctypes.POINTER(ctypes.c_int)

    def decode(buf):
        errors[:] = 0  # the C decoder accumulates into errors[] and reads
        # it back for its stall shortcut (message_passing.c:16-19, :71-73)
        lib.message_passing(
            buf.ctypes.data_as(iptr), ctypes.c_int(iters),
            var_lookup.ctypes.data_as(iptr), chk_lookup.ctypes.data_as(iptr),
            errors.ctypes.data_as(iptr), ctypes.c_int(n), ctypes.c_int(k),
            ctypes.c_int(dv), ctypes.c_int(dc))

    decode(rx[0].copy())  # warm
    start = time.perf_counter()
    for i in range(trials):
        decode(rx[i].copy())
    elapsed = time.perf_counter() - start
    thr = k * trials / elapsed
    print(f"reference C decoder (host CPU, 1 core): "
          f"{elapsed / trials * 1e3:.2f} ms/trial = {thr:.3e} info bits/s "
          f"at n={n}, {iters} iters, eps={eps}")
    return 0


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]) if len(sys.argv) > 1 else 200))
