"""Multi-host Monte Carlo entry point: one ``jax.distributed`` job.

The reference scales across hosts as independent HPC array jobs whose CSV
shards are merged offline (tools/combine_data.py:32-95).  Here every host
runs this module with the same experiment argv; the processes join one
``jax.distributed`` job, the chunk kernel psums the integer counters over
the *global* mesh (all processes' devices), every process sees identical
replicated totals -- so the stopping rules fire in lockstep -- and only
process 0 writes the result.  The offline combine step disappears.

Usage (run the same command on every host, varying only --process-id):

    python -m iib_project_ldpc_codes_tpu.parallel.multihost \
        --coordinator=HOST:PORT --num-processes=N --process-id=I \
        <erasure_prob> <num_tests> <iterations> <n> <dv> <dc> <mode> \
        [seed|filenumber] [expurgation] \
        [--platform=cpu] [--cpu-devices=K] [--output-dir=DIR]

``--platform=cpu --cpu-devices=K`` pins a K-virtual-device CPU backend per
process (used by the 2-process integration test; also handy for dry runs
without GPUs).  On GPU hosts, omit both and run ONE process per host:
that process owns all of the host's local cards and the global mesh spans
every host's cards.  Never start a second process on a host whose cards
are taken: a JAX process reserves most of a card's memory when it starts,
so a second one on the same card fails for want of memory.

``jax.distributed`` is told of the cluster only through these flags (or
the JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID
variables); nothing is discovered automatically.

Prints one JSON line per process with the psum'd counters so launchers can
scrape any process's output (they all agree).
"""

from __future__ import annotations

import json
import sys


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    flags = {}
    positional = []
    for a in argv:
        if a.startswith("--"):
            k, _, v = a[2:].partition("=")
            flags[k] = v if v else True
        else:
            positional.append(a)

    coordinator = flags.get("coordinator")
    num_processes = int(flags["num-processes"]) if "num-processes" in flags \
        else None
    process_id = int(flags["process-id"]) if "process-id" in flags else None

    import jax

    from ..utils.runtime import enable_compile_cache

    enable_compile_cache()
    if flags.get("platform") == "cpu":
        try:
            jax.config.update("jax_num_cpu_devices",
                              int(flags.get("cpu-devices", 1)))
        except RuntimeError:
            pass
        jax.config.update("jax_platforms", "cpu")

    from . import distributed

    active = distributed.initialize(coordinator, num_processes, process_id)

    from ..models.ensemble import code_for_config
    from ..utils.config import SimulationConfig
    from .montecarlo import run_simulation

    if "config" in flags:
        with open(flags["config"]) as f:
            cfg = SimulationConfig.from_json(f.read())
    else:
        if len(positional) < 7:
            print(__doc__)
            return 2
        cfg = SimulationConfig.from_reference_argv(positional)
    if "output-dir" in flags:
        cfg.output_dir = flags["output-dir"]
    if "checkpoint-path" in flags:
        # per-process override: checkpoint files live on host-local disk;
        # process 0's is authoritative (montecarlo.py broadcasts it)
        cfg.checkpoint_path = flags["checkpoint-path"]

    if cfg.decoder in ("ml", "both", "peeling"):
        # These dispatch to host drivers that ignore the mesh: every
        # process would independently repeat the full num_tests (no psum,
        # no trial split) and the per-process wall clock has no broadcast,
        # so this module's "psum'd counters, processes agree" contract
        # would silently not hold.  Run those decoders single-process via
        # the plain CLI instead.
        raise SystemExit(
            f"decoder {cfg.decoder!r} runs through a host driver with no "
            "mesh support; use iib_project_ldpc_codes_tpu.cli (single "
            "process) for ml/both/peeling runs")

    code = None
    if cfg.code_mode == "fixed" or cfg.decoder == "peeling":
        # pure function of (code_number, n, dv, dc): every process derives
        # the identical code with no cross-host broadcast
        code = code_for_config(cfg)

    mesh = distributed.global_mesh()
    result = run_simulation(cfg, code=code, mesh=mesh)
    path = distributed.save_result_primary(result)

    print(json.dumps({
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "distributed": active,
        "mesh_devices": mesh.size,
        "is_primary": distributed.is_primary(),
        "num_trials": result.num_trials,
        "block_errors": result.block_errors,
        "bit_errors": result.bit_errors,
        "error_counts_per_iteration": result.error_counts_per_iteration,
        "stopped_by": result.stopped_by,
        "wrote": path,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
