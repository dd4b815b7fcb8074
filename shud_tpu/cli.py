"""Command-line entry: ``python -m shud_tpu [options] <project>``.

Mirrors the reference CLI (``src/classes/CommandIn.cpp:188-278``):
``./shud <prj>`` reads ``input/<prj>/<prj>.*`` and writes
``output/<prj>.out/``.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="shud_tpu",
        description="SHUD-class watershed hydrology model in JAX",
    )
    p.add_argument("project", nargs="?", default=None,
                   help="project name (input/<prj>/<prj>.*)")
    p.add_argument("-0", "--dummy", action="store_true", dest="dummy",
                   help="dummy run: IO pipeline only, no solving")
    p.add_argument("-g", "--split", action="store_true",
                   help="operator-split (sequential sub-system) mode")
    p.add_argument("-c", "--calib", default=None,
                   help="calibration file (.cfg.calib)")
    p.add_argument("-o", "--output", default=None, help="output folder")
    p.add_argument("-b", "--base", default=".", help="base directory")
    p.add_argument("-e", "--end-day", type=float, default=None,
                   help="override END day")
    p.add_argument("-p", "--project-file", default=None, metavar="SHUD",
                   help="load paths from a <prj>.SHUD project manifest "
                        "(FileIn::readProject)")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="verbose screen output (overrides -q)")
    p.add_argument("-f", "--fflush", action="store_true",
                   help="flush every output record to disk as written")
    p.add_argument("-n", "--num-workers", type=int, default=None,
                   metavar="N",
                   help="reference -n (OpenMP threads / CMA-ES lambda); "
                        "accepted for CLI parity — XLA manages device "
                        "parallelism, use --shards for multi-chip")
    p.add_argument("-q", "--quiet", action="store_true")
    p.add_argument("--cpu", action="store_true",
                   help="force the CPU backend")
    p.add_argument("--per-window", action="store_true",
                   help="use the per-window driver instead of the fused "
                        "lax.scan driver")
    p.add_argument("--f32", action="store_true",
                   help="solve in float32 (local-datum heads) instead of "
                        "float64")
    p.add_argument("--resume", default=None, metavar="CKPT",
                   help="resume from a full binary checkpoint (.ckpt.npz)")
    p.add_argument("--shards", type=int, default=None, metavar="P",
                   help="run domain-decomposed over P devices "
                        "(shard_map; use XLA_FLAGS="
                        "--xla_force_host_platform_device_count=P --cpu "
                        "to simulate P devices on the CPU)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a jax.profiler trace to DIR")
    p.add_argument("--compile-cache", default=None, metavar="DIR",
                   help="persistent XLA compilation-cache directory "
                        "($JAX_COMPILATION_CACHE_DIR when set, else "
                        "<checkout>/.jax_cache; 'off' disables).  A "
                        "process restart reuses compiled programs instead "
                        "of re-paying the day-1 compile cost")
    p.add_argument("--cmaes-dir", default=None, metavar="DIR",
                   help="external-calibration exchange directory (the "
                        "reference's -e dir_cmaes hook, CommandIn.cpp:"
                        "210-212): read DIR/calib_varnames.txt + "
                        "DIR/calib_x.txt (globalCal::copy vector, "
                        "ModelConfigure.cpp:368-375), run, then write "
                        "DIR/objective.txt (-NSE of daily outlet "
                        "discharge vs tsd.obs) and the applied "
                        "DIR/cfg.calib.out for the external driver")
    p.add_argument("--distributed", default=None,
                   metavar="COORD:PORT,NPROC,RANK[,CARD:CARD...]",
                   help="multi-process run: initialise jax.distributed "
                        "before anything else; the optional last field "
                        "lists the cards this process drives (give each "
                        "process on a host its own).  Combine with "
                        "--shards <global device count>")
    args = p.parse_args(argv)

    setup_compile_cache(args.compile_cache)

    if args.distributed is not None:
        from shud_tpu.parallel.runtime import init_distributed

        fields = args.distributed.split(",")
        if len(fields) not in (3, 4):
            p.error("--distributed takes COORD:PORT,NPROC,RANK[,CARDS]")
        cards = ([int(c) for c in fields[3].split(":")]
                 if len(fields) == 4 else None)
        rank_i, n = init_distributed(fields[0], int(fields[1]),
                                     int(fields[2]), local_device_ids=cards)
        if not args.quiet:
            print(f"jax.distributed: process {rank_i}, "
                  f"{n} global devices")

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    if args.quiet and args.verbose:
        args.quiet = False
    if args.fflush:
        from shud_tpu.io import output as _out

        _out.FFLUSH_MODE = True

    inp = None
    if args.project_file:
        from shud_tpu.io.project import load_project, read_project_file

        paths = read_project_file(args.project_file)
        inp = load_project(paths.project, paths=paths)
        args.project = paths.project
        if args.output is None:
            args.output = paths.outpath
    elif args.project is None:
        p.error("a project name (or -p <file>.SHUD) is required")

    calib = None
    if args.calib:
        from shud_tpu.io.project import read_calib

        calib = read_calib(args.calib)
    if args.cmaes_dir:
        calib = _apply_cmaes_dir(args.cmaes_dir, calib)

    if inp is not None and (args.shards is not None or args.split
                            or args.per_window or args.dummy):
        p.error("-p is supported with the default (fused) driver only")

    if args.shards is not None:
        # every reference mode is either honoured or rejected loudly under
        # --shards (no silent drops): -g has no sharded sub-solver set, -0
        # is mode-independent (CommandIn.cpp:195-197), --profile wraps the
        # sharded run exactly as it wraps the fused one
        if args.split:
            p.error("-g (operator-split) is not supported with --shards; "
                    "run the split driver single-chip")
        if args.per_window:
            p.error("--per-window is not supported with --shards (the "
                    "sharded driver is interval-batched by design)")
        if args.dummy:
            # -0: full IO pipeline, no solving — identical in every mode
            from shud_tpu.driver.run import run_project

            run_project(args.project, base=args.base, end_day=args.end_day,
                        verbose=not args.quiet, dummy=True,
                        outpath=args.output, calib=calib)
            return
        import contextlib

        import jax
        import jax.numpy as jnp

        from shud_tpu.parallel.runtime import run_project_sharded

        prof = (jax.profiler.trace(args.profile) if args.profile
                else contextlib.nullcontext())
        with prof:
            run_project_sharded(args.project, base=args.base, p=args.shards,
                                end_day=args.end_day,
                                verbose=not args.quiet,
                                outpath=args.output,
                                float_dtype=jnp.float32 if args.f32 else None,
                                resume=args.resume, calib=calib)
        return

    if args.split:
        from shud_tpu.driver.uncoupled import run_project_split

        run_project_split(args.project, base=args.base,
                          end_day=args.end_day, verbose=not args.quiet,
                          outpath=args.output, calib=calib)
    elif args.per_window or args.dummy:
        from shud_tpu.driver.run import run_project

        run_project(
            args.project,
            base=args.base,
            end_day=args.end_day,
            verbose=not args.quiet,
            dummy=args.dummy,
            outpath=args.output,
            calib=calib,
        )
    else:
        import contextlib

        import jax
        import jax.numpy as jnp

        from shud_tpu.driver.run_fast import run_project_fast
        from shud_tpu.utils.errors import ShudError

        prof = (jax.profiler.trace(args.profile) if args.profile
                else contextlib.nullcontext())
        try:
            with prof:
                run_project_fast(
                    args.project,
                    base=args.base,
                    end_day=args.end_day,
                    verbose=not args.quiet,
                    float_dtype=jnp.float32 if args.f32 else jnp.float64,
                    outpath=args.output,
                    calib=calib,
                    resume=args.resume,
                    inp=inp,
                )
        except ShudError as e:  # reference myexit: typed exit codes
            print(f"FATAL: {e}", flush=True)
            raise SystemExit(e.code)
        if args.cmaes_dir:
            _write_cmaes_objective(args.cmaes_dir, args.project, args.base,
                                   args.output, calib,
                                   quiet=args.quiet)


# the checkout's own cache directory: a fixed path, so that the cache's
# key (which includes the path) is the same in every run from this checkout
CHECKOUT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def setup_compile_cache(cache_dir: "str | None" = None,
                        min_compile_secs: float = 1.0) -> "str | None":
    """Wire JAX's persistent compilation cache (on by default).

    ``$JAX_COMPILATION_CACHE_DIR`` wins when set; otherwise *cache_dir*,
    or ``CHECKOUT_CACHE`` when that is None.  ``"off"`` disables the cache.
    Returns the directory in use (None when off).  A warm restart replays
    the compiled programs from disk instead of re-paying the day-1 compile.
    Sub-second compiles are NOT cached (``min_compile_secs``): they gain
    nothing, and reloading XLA:CPU AOT entries for the tiny host-side
    helper programs spams machine-feature-mismatch warnings on every
    start."""
    import jax

    if cache_dir == "off":
        jax.config.update("jax_enable_compilation_cache", False)
        return None
    cache_dir = (os.environ.get("JAX_COMPILATION_CACHE_DIR") or cache_dir
                 or CHECKOUT_CACHE)
    os.makedirs(cache_dir, exist_ok=True)
    jax.config.update("jax_enable_compilation_cache", True)
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return cache_dir


def _apply_cmaes_dir(dir_cmaes: str, base_calib):
    """Read the external driver's candidate vector
    (DIR/calib_varnames.txt: one calibration key per line;
    DIR/calib_x.txt: whitespace/newline-separated values) and apply it via
    the globalCal::copy semantics (ModelConfigure.cpp:368-375: nx >= nv,
    pairwise push)."""
    import numpy as np

    from shud_tpu.utils.calibrate import calib_from_vector

    vn_path = os.path.join(dir_cmaes, "calib_varnames.txt")
    x_path = os.path.join(dir_cmaes, "calib_x.txt")
    if not (os.path.exists(vn_path) and os.path.exists(x_path)):
        return base_calib
    with open(vn_path) as fh:
        names = [ln.strip() for ln in fh if ln.strip()
                 and not ln.startswith("#")]
    x = np.loadtxt(x_path).ravel()
    if len(x) < len(names):  # ERRCONSIS in the reference
        raise SystemExit(
            f"--cmaes-dir: {len(names)} varnames but only {len(x)} values")
    return calib_from_vector(names, x[: len(names)], base=base_calib)


def _write_cmaes_objective(dir_cmaes: str, project: str, base: str,
                           outpath, calib, quiet=False):
    """Post-run: objective (-NSE of daily outlet discharge vs tsd.obs) and
    the applied calibration, for the external CMA-ES driver to collect."""
    from shud_tpu.analysis import Run
    from shud_tpu.io.project import write_calib

    inpath = os.path.join(base, "input", project)
    out = outpath or os.path.join(base, "output", f"{project}.out")
    run = Run(project, inpath=inpath, outpath=out)
    obj = float("nan")
    try:
        obj = -float(run.nse())  # aligned daily outlet-vs-gauge NSE
    except (OSError, KeyError, IndexError, ValueError) as e:
        if not quiet:
            print(f"--cmaes-dir: objective unavailable ({e})")
    os.makedirs(dir_cmaes, exist_ok=True)
    with open(os.path.join(dir_cmaes, "objective.txt"), "w") as fh:
        fh.write(f"{obj:.10e}\n")
    if calib is not None:
        write_calib(calib, os.path.join(dir_cmaes, "cfg.calib.out"))
    if not quiet:
        print(f"--cmaes-dir: objective {obj:.6f} -> "
              f"{os.path.join(dir_cmaes, 'objective.txt')}")


if __name__ == "__main__":
    main()
