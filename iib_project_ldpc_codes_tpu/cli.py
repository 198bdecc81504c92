"""Command-line entry point.

Two invocation styles:

  1. Reference-compatible positional argv (parallel_simulator.py:403-445):

       python -m iib_project_ldpc_codes_tpu.cli \
           <erasure_prob> <num_tests> <iterations> <n> <dv> <dc> <mode> \
           [seed|filenumber] [expurgation]

     with modes 0-5 = {MP, ML, both} x {random ensemble, fixed code}.

  2. A JSON config:  python -m iib_project_ldpc_codes_tpu.cli --config cfg.json

Optional flags (either style):
  --platform=cpu|gpu     force the backend (gpu: fail unless a CUDA card
                         is present; default: whatever jax picks)
  --devices=N            shard the batch over N devices (mesh + psum)
  --edge-sharded         shard the Tanner graph instead of the batch
                         (huge-n fixed-code BEC runs, n ~ 10^6)
  --output-dir=DIR       where results are written
  --legacy-csv           also write the reference CSV format
"""

from __future__ import annotations

import sys


def _apply_platform(flag: str | None, n_devices: int | None):
    import jax

    if flag == "cpu":
        try:
            if n_devices:
                jax.config.update("jax_num_cpu_devices", n_devices)
        except RuntimeError:
            pass
        jax.config.update("jax_platforms", "cpu")
    elif flag == "gpu":
        # CUDA only: backend start-up fails loudly when there is no card,
        # and main() checks the platform in case the backends were
        # already up when this ran.
        jax.config.update("jax_platforms", "cuda")
    elif flag not in (None, True):
        jax.config.update("jax_platforms", str(flag))


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

    from .utils.config import SimulationConfig
    from .utils.runtime import device_info, enable_compile_cache, require_gpu

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
    if flags.get("legacy-csv"):
        cfg.write_legacy_csv = True
    if flags.get("edge-sharded"):
        # huge-n runs: shard the Tanner graph across the mesh instead of
        # the trial batch (fixed-code BEC+bp; parallel/edge_sharded.py)
        cfg.edge_sharded = True
        cfg.__post_init__()  # re-validate the flag combination

    n_devices = int(flags["devices"]) if "devices" in flags else None
    _apply_platform(flags.get("platform"), n_devices)
    enable_compile_cache()

    import jax

    info = (require_gpu() if flags.get("platform") == "gpu"
            else device_info())
    print(f"platform={info['platform']} device_kind={info['kind']} "
          f"device_count={info['count']}")

    from .models.ensemble import code_for_config
    from .parallel.mesh import make_mesh
    from .parallel.montecarlo import run_simulation
    from .utils.results import save_result

    code = None
    if cfg.code_mode == "fixed" or cfg.decoder == "peeling":
        code = code_for_config(cfg)

    mesh = None
    if n_devices and n_devices > 1:
        mesh = make_mesh(jax.devices()[:n_devices])

    result = run_simulation(cfg, code=code, mesh=mesh)
    path = save_result(result)
    print(f"wrote {path}")
    print(f"trials={result.num_trials} block_error_rate="
          f"{result.block_error_rate:.6g} bit_error_rate="
          f"{result.bit_error_rate:.6g} stopped_by={result.stopped_by}")
    if result.optimal_block_error_rate is not None:
        print(f"optimal_block_error_rate="
              f"{result.optimal_block_error_rate:.6g} "
              f"optimal_bit_error_rate={result.optimal_bit_error_rate:.6g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
