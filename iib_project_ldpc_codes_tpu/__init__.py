"""LDPC simulation & decoding framework on JAX/XLA accelerators.

A from-scratch JAX/XLA re-design of the capabilities of
roryhighnam/iib_project_ldpc_codes (BER/FER Monte Carlo estimation of
(dv,dc)-regular LDPC ensembles over erasure/flip/AWGN channels, with
iterative message-passing, peeling and maximum-likelihood decoders,
validated against density-evolution and finite-length scaling theory).

Design stance (not a port):
  * codes are flattened Tanner-graph edge-list structs; both decoder
    update directions are static *gathers*, never scatters;
  * the BEC erasure-BP hot loop is bit-packed, 32 codewords per int32
    lane element, batched in the lane dimension;
  * Monte Carlo trials are vmapped/batched on one chip and sharded over a
    ``jax.sharding.Mesh`` with ``psum``'d error counters across chips;
  * all RNG is ``jax.random`` with threaded keys (reproducible by seed,
    fixing the reference's ignored-seed bug, random_code_generator.c:23).
"""

__version__ = "0.1.0"

from .models.code import LDPCCode, code_from_checks, dense_parity_check
from .models.ensemble import sample_code, sample_codes
from .models.irregular import IrregularEnsembleSpec, IrregularLDPCCode
from .ops.channels import BEC, BSC, AWGN, ERASURE

__all__ = [
    "LDPCCode",
    "code_from_checks",
    "dense_parity_check",
    "sample_code",
    "sample_codes",
    "IrregularEnsembleSpec",
    "IrregularLDPCCode",
    "BEC",
    "BSC",
    "AWGN",
    "ERASURE",
]
