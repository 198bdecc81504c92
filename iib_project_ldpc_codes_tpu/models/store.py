"""Code artifact storage, including reference-compatible .npy export.

The reference caches parity checks and lookup tables as per-code ``.npy``
files keyed by (code_no, n, dv, dc) (parallel_simulator.py:289-335,
tools/generate_lookups.py).  This framework's codes are deterministic
functions of a key, so persistence is optional -- but interop matters:
this module round-trips codes through the reference's exact file naming
and array formats (dense bool H ``code_no_*`` + flattened int32
``check_*`` / ``variable_*`` lookups).
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from .code import LDPCCode, code_from_dense, dense_parity_check


def reference_filenames(code_number: int, n: int, dv: int, dc: int
                        ) -> Tuple[str, str, str]:
    """(H, check_lookup, variable_lookup) filenames in the reference's
    scheme (parallel_simulator.py:290-292)."""
    stem = f"code_no_{code_number}_n_{n}_dv_{dv}_dc_{dc}.npy"
    return stem, "check_" + stem, "variable_" + stem


def save_reference_format(code: LDPCCode, directory: str,
                          code_number: int = 1) -> Tuple[str, str, str]:
    """Write H + both lookups exactly as the reference stores them."""
    os.makedirs(directory, exist_ok=True)
    h_name, c_name, v_name = reference_filenames(
        code_number, code.n, code.dv, code.dc)
    h = dense_parity_check(code)
    check_lookup = np.sort(np.asarray(code.chk_to_var), axis=1).reshape(-1)
    variable_lookup = np.asarray(code.var_to_chk).reshape(-1)
    np.save(os.path.join(directory, h_name), h)
    np.save(os.path.join(directory, c_name),
            check_lookup.astype(np.int32))
    np.save(os.path.join(directory, v_name),
            variable_lookup.astype(np.int32))
    return h_name, c_name, v_name


def load_reference_format(directory: str, code_number: int, n: int,
                          dv: int, dc: int) -> LDPCCode:
    """Load a code stored in the reference's format (H is authoritative;
    lookups are validated against it, tools/code_checker.py behaviour)."""
    h_name, c_name, v_name = reference_filenames(code_number, n, dv, dc)
    h = np.load(os.path.join(directory, h_name))
    code = code_from_dense(h)
    c_path = os.path.join(directory, c_name)
    if os.path.exists(c_path):
        check_lookup = np.load(c_path).reshape(code.m, dc)
        if not (np.sort(check_lookup, axis=1)
                == np.sort(np.asarray(code.chk_to_var), axis=1)).all():
            raise ValueError("stored check lookup inconsistent with H")
    return code


def save_code(code: LDPCCode, path: str) -> None:
    """Native compact format: one .npz with the socket table."""
    np.savez_compressed(path, chk_to_var=np.asarray(code.chk_to_var),
                        n=code.n, dv=code.dv, dc=code.dc)


def load_code(path: str) -> LDPCCode:
    from .code import code_from_checks
    import jax.numpy as jnp

    z = np.load(path)
    return code_from_checks(jnp.asarray(z["chk_to_var"]), n=int(z["n"]),
                            dv=int(z["dv"]), dc=int(z["dc"]))


def save_qc_code(code, path: str) -> None:
    """Persist a quasi-cyclic code (regular QCLDPCCode or
    IrregularQCLDPCCode) as base table + shifts + lift size -- the
    compact form standards publish (a few KB regardless of n)."""
    from .qc import IrregularQCLDPCCode

    np.savez_compressed(
        path, base_chk=np.asarray(code.base_chk),
        shifts=np.asarray(code.shifts), Z=code.Z, nb=code.nb,
        irregular=isinstance(code, IrregularQCLDPCCode),
        mb=getattr(code, "mb", 0),
        dv=getattr(code, "dv", 0), dc=getattr(code, "dc", 0))


def load_qc_code(path: str):
    import jax.numpy as jnp

    from .qc import IrregularQCLDPCCode, QCLDPCCode

    z = np.load(path)
    base = jnp.asarray(z["base_chk"])
    shifts = jnp.asarray(z["shifts"])
    if bool(z["irregular"]):
        return IrregularQCLDPCCode(base_chk=base, shifts=shifts,
                                   Z=int(z["Z"]), nb=int(z["nb"]),
                                   mb=int(z["mb"]))
    return QCLDPCCode(base_chk=base, shifts=shifts, Z=int(z["Z"]),
                      nb=int(z["nb"]), dv=int(z["dv"]), dc=int(z["dc"]))
