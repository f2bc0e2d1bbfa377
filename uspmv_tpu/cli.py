"""Command-line driver.

Mirrors the reference binary's CLI (parse_cli_inputs, utilities.hpp:
1047-1545; usage in README.md):

    uspmv <matrix.mtx | Generator,args> <crs|scs> [options]

    -c N                 chunk size C (scs)             [1]
    -s N                 sigma sorting scope (scs)      [1]
    -mode b|s            bench | solve                  [b]
    -rev N               solve repetitions              [1]
    -bench_time S        bench target seconds           [5.0]
    -dp|-sp|-hp          uniform precision              [dp]
    -ap_value_type T     ap[dp_sp]|ap[dp_hp]|ap[sp_hp]|ap[dp_sp_hp]
    -ap_threshold_1 X    dp/sp (or first) threshold
    -ap_threshold_2 X    second threshold (3-way)
    -dropout 0|1         drop tiny elements (we implement it; the
                         reference parses but ignores it)
    -dropout_threshold X
    -block_vec_size N    SpMMV width                    [1]
    -layout L            rowwise|colwise                [colwise]
    -rand_x 0|1|m        x init: default|random|matrix-mean
    -equilibrate 0|1     row/col max-abs scaling
    -seg_method M        seg-rows|seg-nnz|seg-metis
    -n_shards N          devices along the row mesh axis [1]
    -comm_mode M         bulkvec|multivec|singlevec|graphtopo|allgather
    -comm_halos 0|1, -ba_synch 0|1, -par_pack 0|1, -no_pack 0|1
    -print_comm_vol 0|1
    -split_rows_threshold N   heavy-row splitting (0=auto, -1=off)
    -validate 0|1        solve-mode scipy validation    [1]
    -verbose 0|1
    -matrix_stats        print matrix statistics and exit
    -output_sparsity     dump per-precision SCS .mtx and exit
    -backend auto|gpu|cpu  execution platform; gpu fails without a GPU
    -coordinator H:P     multi-host: jax.distributed coordinator address
    -n_processes N, -process_id I, -local_devices D (CPU testing)
    -impl auto|xla|bcoo  kernel implementation (auto = the SELL-C-sigma
                         Triton kernel on a GPU, XLA on the CPU; bcoo =
                         independent jax.experimental.sparse baseline,
                         cuSPARSE on a GPU)
    -mtx_out DIR         report/output directory        [.]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from .config import Config
from .formats.stats import get_matrix_stats
from .io.generators import generate_matrix
from .io.mmio import read_mtx


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="uspmv",
        description="Ultimate-SpMV in JAX: SELL-C-sigma SpMV/SpMMV "
        "benchmarking and validation on NVIDIA GPUs (and the CPU)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("matrix", help=".mtx file or generator spec 'Name,args'")
    p.add_argument("kernel_format", choices=["crs", "scs"])
    p.add_argument("-c", type=int, default=1, dest="chunk_size")
    p.add_argument("-s", type=int, default=1, dest="sigma")
    p.add_argument("-mode", choices=["b", "s"], default="b")
    p.add_argument("-rev", type=int, default=1, dest="n_repetitions")
    p.add_argument("-bench_time", type=float, default=5.0)
    prec = p.add_mutually_exclusive_group()
    prec.add_argument("-dp", action="store_true")
    prec.add_argument("-sp", action="store_true")
    prec.add_argument("-hp", action="store_true")
    prec.add_argument(
        "-ap_value_type",
        choices=["ap[dp_sp]", "ap[dp_hp]", "ap[sp_hp]", "ap[dp_sp_hp]"],
        default=None,
    )
    p.add_argument("-ap_threshold_1", type=float, default=0.0)
    p.add_argument("-ap_threshold_2", type=float, default=0.0)
    p.add_argument("-dropout", type=int, choices=[0, 1], default=0)
    p.add_argument("-dropout_threshold", type=float, default=0.0)
    p.add_argument("-block_vec_size", type=int, default=1)
    p.add_argument("-layout", choices=["rowwise", "colwise"], default="colwise")
    p.add_argument("-rand_x", choices=["0", "1", "m"], default="0")
    p.add_argument("-equilibrate", type=int, choices=[0, 1], default=0)
    p.add_argument("-jacobi_scale", type=int, choices=[0, 1], default=0)
    p.add_argument(
        "-seg_method",
        choices=["seg-rows", "seg-nnz", "seg-metis"],
        default="seg-rows",
    )
    p.add_argument("-n_shards", type=int, default=1)
    p.add_argument(
        "-comm_mode",
        choices=["bulkvec", "multivec", "singlevec", "graphtopo",
                 "allgather"],
        default="bulkvec",
    )
    p.add_argument("-comm_halos", type=int, choices=[0, 1], default=1)
    p.add_argument("-ba_synch", type=int, choices=[0, 1], default=1)
    p.add_argument("-par_pack", type=int, choices=[0, 1], default=1)
    p.add_argument("-no_pack", type=int, choices=[0, 1], default=0)
    p.add_argument("-print_comm_vol", type=int, choices=[0, 1], default=0)
    p.add_argument("-overlap", type=int, choices=[0, 1], default=1,
                   help="overlap halo exchange with interior SpMV")
    p.add_argument("-split_rows_threshold", type=int, default=0,
                   help="heavy-row split threshold: 0 = auto (4x the mean "
                        "row length, 32..1024), -1 = disabled, N = split "
                        "rows longer than N")
    p.add_argument("-validate", type=int, choices=[0, 1], default=1)
    p.add_argument("-verbose", type=int, choices=[0, 1], default=0)
    p.add_argument("-matrix_stats", action="store_true")
    p.add_argument("-output_sparsity", action="store_true")
    p.add_argument("-backend", choices=["auto", "gpu", "cpu"],
                   default="auto",
                   help="execution platform; gpu raises when the process "
                   "has no GPU")
    p.add_argument(
        "-impl", choices=["auto", "xla", "bcoo"], default="auto",
        help="auto = the SELL-C-sigma Triton kernel on a GPU, XLA on the "
        "CPU; xla = force the XLA path; bcoo = independent "
        "jax.experimental.sparse baseline (cuSPARSE on a GPU)",
    )
    p.add_argument("-debug", type=int, choices=[0, 1], default=0,
                   help="DEBUG_MODE_FINE analogue: stage dumps + checks")
    p.add_argument("-log_prof", default=None, metavar="LOGDIR",
                   help="capture a jax profiler trace of the bench loop to "
                        "LOGDIR (LIKWID marker analogue)")
    # multi-host bootstrap (reference: mpirun + MPI_Init, main.cpp:1822-1826):
    # one process per GPU, each given the coordinator, the process count
    # and its own id
    p.add_argument("-coordinator", default=None, metavar="HOST:PORT",
                   help="jax.distributed coordinator address "
                        "(multi-host runs; process 0's host)")
    p.add_argument("-n_processes", type=int, default=None)
    p.add_argument("-process_id", type=int, default=None)
    p.add_argument("-local_devices", type=int, default=None,
                   help="force per-process CPU device count (testing)")
    p.add_argument("-mtx_out", default=".", dest="output_dir")
    p.add_argument("-seed", type=int, default=42)
    p.add_argument("-json", action="store_true", help="print result as JSON")
    return p


def config_from_args(args) -> Config:
    if args.ap_value_type:
        value_type = args.ap_value_type
    elif args.sp:
        value_type = "sp"
    elif args.hp:
        value_type = "hp"
    else:
        value_type = "dp"
    return Config(
        chunk_size=args.chunk_size if args.kernel_format == "scs" else 1,
        sigma=args.sigma if args.kernel_format == "scs" else 1,
        kernel_format=args.kernel_format,
        value_type=value_type,
        block_vec_size=args.block_vec_size,
        vector_layout=args.layout,
        random_init_x=(args.rand_x == "1"),
        mean_init_x=(args.rand_x == "m"),
        mode=args.mode,
        n_repetitions=args.n_repetitions,
        bench_time=args.bench_time,
        validate_result=bool(args.validate),
        verbose=bool(args.verbose),
        ap_threshold_1=args.ap_threshold_1,
        ap_threshold_2=args.ap_threshold_2,
        dropout=bool(args.dropout),
        dropout_threshold=args.dropout_threshold,
        equilibrate=bool(args.equilibrate),
        jacobi_scale=bool(args.jacobi_scale),
        seg_method=args.seg_method,
        comm_mode=args.comm_mode,
        comm_halos=bool(args.comm_halos),
        ba_synch=bool(args.ba_synch),
        par_pack=bool(args.par_pack),
        no_pack=bool(args.no_pack),
        print_comm_vol=bool(args.print_comm_vol),
        overlap_comm=bool(args.overlap),
        split_rows_threshold=args.split_rows_threshold,
        n_shards=args.n_shards,
        backend=args.backend,
        impl=args.impl,
        output_dir=args.output_dir,
        matrix_file_name=args.matrix,
        seed=args.seed,
        debug_mode=bool(args.debug),
        log_prof=args.log_prof is not None,
    )


def load_matrix(spec: str):
    if spec.endswith(".mtx"):
        return read_mtx(spec)
    return generate_matrix(spec)


_REFERENCE_ALIASES = {
    # the reference's exact spellings (utilities.hpp:1325-1360)
    "-apt1": ["-ap_threshold_1"],
    "-apt2": ["-ap_threshold_2"],
    "-do": ["-dropout"],
    "-dt": ["-dropout_threshold"],
    "-seg_rows": ["-seg_method", "seg-rows"],
    "-seg-rows": ["-seg_method", "seg-rows"],
    "-seg_nnz": ["-seg_method", "seg-nnz"],
    "-seg-nnz": ["-seg_method", "seg-nnz"],
    "-seg_metis": ["-seg_method", "seg-metis"],
    "-seg-metis": ["-seg_method", "seg-metis"],
}


def translate_reference_flags(argv):
    """Accept the reference binary's exact flag spellings
    (-ap[dp_sp], -apt1, -seg_rows, ...) alongside our own."""
    out = []
    for a in argv:
        if a.startswith("-ap[") and a.endswith("]"):
            out += ["-ap_value_type", a[1:]]
        elif a in _REFERENCE_ALIASES:
            out += _REFERENCE_ALIASES[a]
        else:
            out.append(a)
    return out


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    argv = translate_reference_flags(list(argv))
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    cfg.validate()

    if cfg.backend == "cpu":
        # before the first device query: a CPU run never opens (and never
        # reserves memory on) a GPU another process may be using
        import jax

        jax.config.update("jax_platforms", "cpu")

    import os as _os

    primary = True
    if (args.coordinator or args.n_processes
            or _os.environ.get("USPMV_COORDINATOR")):
        from .parallel.multihost import initialize

        info = initialize(
            args.coordinator, args.n_processes, args.process_id,
            local_devices=args.local_devices,
            platform=(args.backend if args.backend != "auto" else None),
        )
        primary = info["process_id"] == 0
        if cfg.verbose and primary:
            print(f"[multihost] {info}")

    mtx = load_matrix(args.matrix)
    if args.matrix_stats:
        print(get_matrix_stats(mtx).summary())
        return 0

    from .runtime.operator import SpmvOperator
    from .runtime.bench import bench_spmv
    from .runtime.report import (
        format_bench_block,
        format_result_block,
        write_bench_to_file,
        write_result_to_file,
    )
    from .runtime.validate import validate_solve

    if cfg.impl == "bcoo":
        from .ops.spmv_bcoo import BcooSpmvOperator

        op = BcooSpmvOperator.from_mtx(cfg, mtx)
    elif cfg.n_shards > 1:
        from .parallel.distributed import DistributedSpmvOperator

        op = DistributedSpmvOperator.from_mtx(cfg, mtx)
    else:
        op = SpmvOperator.from_mtx(cfg, mtx)

    if args.output_sparsity:
        # reference OUTPUT_SPARSITY: dump per-precision SCS and exit
        for path in op.dump_sparsity(cfg.output_dir):
            print(f"wrote {path}")
        return 0

    if cfg.mode == "b":
        from .runtime import profiling

        marker = profiling.kernel_marker_name(cfg)
        with profiling.trace(args.log_prof, enabled=args.log_prof is not None):
            with profiling.marker(marker, enabled=args.log_prof is not None):
                res = bench_spmv(op)
        if primary:  # reference: rank 0 writes (main.cpp:1772-1800)
            write_bench_to_file(cfg, res)
            if args.json:
                print(json.dumps(res.to_dict()))
            else:
                print(format_bench_block(cfg, res))
        return 0

    # solve mode
    from .ops.vectors import init_x_host

    checker = None
    if cfg.debug_mode:
        from .runtime.sanity import SanityChecker

        checker = SanityChecker(cfg.output_dir)
        for s in getattr(op, "scs", {}).values():
            # distributed operators hold per-shard lists
            for si in (s if isinstance(s, list) else [s]):
                checker.check_scs_padding(si)

    x0 = init_x_host(
        cfg, op.n_rows, op.matrix_stats, dtype=np.float64
    )
    xd = op.make_x(x0)
    if checker:
        checker.dump_stage("before_solve", x=np.asarray(xd))
    _, y = op.solve(xd, cfg.n_repetitions)
    y_host = op.to_host(y)
    if checker:
        checker.dump_stage("after_solve", y=np.asarray(y_host))
        checker.check_finite("solve result", y_host)
        print(f"[debug] sanity dumps -> {checker.path}")
    if cfg.validate_result:
        # the oracle must see the same preprocessed operator: the reference
        # equilibrates total_mtx before the MKL compare (main.cpp:1753-1754)
        mtx_oracle = mtx
        if cfg.equilibrate or cfg.jacobi_scale:
            from .formats.coo import equilibrate_matrix, jacobi_scale_matrix

            mtx_oracle = mtx.copy()
            if cfg.jacobi_scale:
                jacobi_scale_matrix(mtx_oracle)
            if cfg.equilibrate:
                equilibrate_matrix(mtx_oracle)
        # bf16 bound scales with the bf16-partition nnz fraction (an AP
        # mix dominated by dp/sp must be held near the tighter bound)
        npp = op.nnz_per_precision()
        hp_frac = (
            npp.get("hp", 0) / max(sum(npp.values()), 1)
            if cfg.is_ap else 1.0
        )
        rep = validate_solve(
            mtx_oracle, x0, np.asarray(y_host, dtype=np.float64),
            cfg.n_repetitions, value_type=cfg.value_type,
            hp_nnz_fraction=hp_frac,
        )
        if primary:
            write_result_to_file(cfg, rep, cfg.n_repetitions)
            if args.json:
                print(json.dumps({"validation": dataclass_dict(rep)}))
            else:
                print(format_result_block(cfg, rep, cfg.n_repetitions))
        return 0 if rep.ok else 1
    if primary:
        print("solve completed (validation disabled)")
    return 0


def dataclass_dict(obj):
    import dataclasses

    return dataclasses.asdict(obj)


if __name__ == "__main__":
    sys.exit(main())
