"""Process set-up shared by the entry points (CLI, multi-host job,
benchmark, chip smoke test): the persistent compile cache, the GPU
check, and a description of the devices a run actually used."""

from __future__ import annotations

import os
import subprocess
from pathlib import Path
from typing import Optional

#: The checkout's compile cache, used when JAX_COMPILATION_CACHE_DIR is
#: unset.  The path is fixed (never a temporary name, a pid or a time):
#: JAX keys cache entries by their directory, so a moving one never hits.
CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    Call before the first compile.  Where JAX_COMPILATION_CACHE_DIR is
    set, JAX has already read it and nothing is changed here.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    return str(CACHE_DIR)


def device_info(devices=None) -> dict:
    """Platform, device kind and count of ``devices`` (default: all)."""
    import jax

    devices = list(jax.devices() if devices is None else devices)
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind, "count": len(devices)}


def require_gpu(devices=None) -> dict:
    """Fail unless JAX runs on a GPU; returns :func:`device_info`.

    A missing or broken CUDA backend must not turn into a silent run on
    the CPU, whose numbers would then pass for the card's."""
    try:
        info = device_info(devices)
    except (RuntimeError, AssertionError) as err:
        # JAX asserts instead of raising when "cuda" is pinned and no
        # card is visible
        raise SystemExit(
            f"no GPU: JAX could not start a CUDA backend ({err!r})") from err
    if info["platform"] != "gpu":
        raise SystemExit(f"no GPU: JAX runs on {info['platform']} "
                         f"({info['kind']}, {info['count']} device(s))")
    return info


def gpu_name_and_power_limit() -> Optional[str]:
    """``nvidia-smi --query-gpu=name,power.limit`` for every card, one
    line each, or None where nvidia-smi is absent.  A card set below its
    maximum power runs slower under load, so every time taken on it is
    reported beside this line.  nvidia-smi holds no card memory, so it
    does not compete with the JAX process that owns the card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip()
