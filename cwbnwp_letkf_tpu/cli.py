"""Command-line driver: the reference's ``cwb_letkf.f90`` pipeline.

    python -m cwbnwp_letkf_tpu.cli --input ../input --output ../output

File conventions preserved from cwb_letkf.f90:26,42,49-51,70,76:

    <input>/input.nml              namelist config
    <input>/wrfinput_nc_###        prior members (3-digit, 1-based)
    <input>/gts_letkf_###          per-member GTS omboma files
    <input>/obs_gts                station-altitude ASCII (optional)
    <input>/VR_letkf_### MR_letkf_###   radar radial-velocity/reflectivity
    <output>/wrfout_nc_###         analysis members
    <output>/wrfout_nc_mean        analysis mean (write_analy_mean)

The reference's main wires only VR and MR radar files (cwb_letkf.f90:50-51)
even though the radar module supports zdr/kdp; ``--all-radar`` additionally
reads MD/MK files (framework extension).
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Dict


def use_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory; return it.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is set here.  Otherwise the cache goes to ``.jax_cache`` at the
    root of the checkout, a fixed path, so that later processes of this
    checkout find what earlier ones compiled.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cwbnwp-letkf-tpu",
        description="LETKF analysis for WRF ensembles")
    p.add_argument("--input", default="../input", help="input directory")
    p.add_argument("--output", default="../output", help="output directory")
    p.add_argument("--namelist", default=None,
                   help="namelist path (default <input>/input.nml)")
    p.add_argument("--all-radar", action="store_true",
                   help="also read MD/MK (zdr/kdp) radar files")
    p.add_argument("--chunk", type=int, default=4096,
                   help="analysis points per device batch")
    p.add_argument("--no-mesh", action="store_true",
                   help="single-device update (skip sharding)")
    p.add_argument("--stream", action="store_true",
                   help="memory-bounded mode: hold one variable group in "
                        "host RAM at a time (the reference's "
                        "one-variable-resident pipeline, "
                        "module_letkf_core.f90:59-297); fields stream from "
                        "the prior files and analysis writes happen per "
                        "group instead of all-at-once")
    p.add_argument("--platform", default=None,
                   help="force the JAX backend ('cpu' or 'gpu'); applied "
                        "before jax.distributed.initialize")
    p.add_argument("--distributed", action="store_true",
                   help="multi-host mode: jax.distributed.initialize(), "
                        "member-block ingest per process, point-sharded "
                        "update over the global mesh, per-process member "
                        "write-back (the reference's multi-rank main, "
                        "cwb_letkf.f90:20-81; rank->member binding "
                        ":39-52).  Implies --stream (one group resident); "
                        "requires a shared filesystem.  Coordinator "
                        "settings come from the environment "
                        "(JAX_COORDINATOR_ADDRESS etc.) or the flags "
                        "below")
    p.add_argument("--coordinator", default=None,
                   help="coordinator address host:port (distributed)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--metrics-json", default=None,
                   help="write run metrics as one JSON line to this path")
    p.add_argument("--profile-dir", default=None,
                   help="capture a jax.profiler trace of the update into "
                        "this directory (view with XProf/TensorBoard)")
    p.add_argument("--device-breakdown", action="store_true",
                   help="measure per-stage device time (neighbor search / "
                        "gather+whiten / eigh / weight apply) on a sample "
                        "batch and include it in the metrics")
    return p


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)

    from .config import LetkfConfig
    from .driver import StageTimer, run_analysis
    from .metrics import RunMetrics
    from .models.state import (StreamingWrfEnsemble, read_ensemble,
                               write_ensemble, write_mean)
    from .obs.gts import AltTable, parse_obs_gts, read_gts_ensemble
    from .obs.radar import PREFIX_TO_NAME, read_radar_ensemble
    from .projection import LambertProjection

    import jax

    use_compile_cache()
    mesh = None
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    if args.distributed:
        kw = {}
        if args.coordinator:
            kw = dict(coordinator_address=args.coordinator,
                      num_processes=args.num_processes,
                      process_id=args.process_id)
        jax.distributed.initialize(**kw)
        from .parallel import make_mesh

        mesh = make_mesh()

    timer = StageTimer(enabled=not args.quiet)
    metrics = RunMetrics()
    metrics.record_devices(jax.devices())
    timer.stamp("devices: {platform} {kind} x{count}".format(
        **metrics.devices))
    timer.stamp("reading namelist")
    nml = args.namelist or os.path.join(args.input, "input.nml")
    cfg = LetkfConfig.from_namelist(nml)
    k = cfg.nmember
    proj = LambertProjection.from_config(cfg.projection)

    member = lambda stem, m: os.path.join(args.input, f"{stem}_{m+1:03d}")

    timer.stamp("reading model data")
    wrf_paths = [member("wrfinput_nc", m) for m in range(k)]
    out_paths = [os.path.join(args.output, f"wrfout_nc_{m+1:03d}")
                 for m in range(k)]
    if args.distributed:
        # member-block ingest: this process reads/writes only its members
        # (cwb_letkf.f90:39-52); streaming so multi-host composes with the
        # memory-bounded pipeline
        from .parallel.multihost import member_block

        os.makedirs(args.output, exist_ok=True)
        ens = StreamingWrfEnsemble(wrf_paths, cfg, out_paths,
                                   members=member_block(k, mesh))
    elif args.stream:
        os.makedirs(args.output, exist_ok=True)
        ens = StreamingWrfEnsemble(wrf_paths, cfg, out_paths)
    else:
        ens = read_ensemble(wrf_paths, cfg)

    timer.stamp("read obs data")
    obs_data: Dict[str, object] = {}
    gts_paths = [member("gts_letkf", m) for m in range(k)]
    if all(os.path.exists(p) for p in gts_paths):
        alt_path = os.path.join(args.input, "obs_gts")
        if os.path.exists(alt_path):
            alt = parse_obs_gts(alt_path)
        else:
            # the reference cannot run without obs_gts (it open()s it
            # unconditionally, gts_omboma.f90:726); we allow it for
            # synthetic cases but say so — altitudes become 0
            alt = None
            print(f"WARNING: no {alt_path}; station altitudes set to 0 "
                  "(vertical localization of GTS obs is then surface-"
                  "relative only)", file=sys.stderr)
        obs_data.update(read_gts_ensemble(gts_paths, proj, alt))
    prefixes = ("VR", "MR") + (("MD", "MK") if args.all_radar else ())
    for prefix in prefixes:
        paths = [member(f"{prefix}_letkf", m) for m in range(k)]
        if all(os.path.exists(p) for p in paths):
            po = read_radar_ensemble(paths, proj)
            if po is not None:
                obs_data[PREFIX_TO_NAME[prefix]] = po

    timer.stamp("get into letkf core")
    if mesh is None and not args.no_mesh:
        from .parallel import make_mesh

        if len(jax.devices()) > 1:
            mesh = make_mesh()
    from .profiling import maybe_trace

    with maybe_trace(args.profile_dir):
        run_analysis(cfg, ens, obs_data, mesh=mesh, chunk=args.chunk,
                     timer=timer, metrics=metrics,
                     device_breakdown=args.device_breakdown,
                     distributed=args.distributed)
    timer.stamp("finish letkf core")

    os.makedirs(args.output, exist_ok=True)
    if args.distributed:
        # every process's sinks are complete; the optional mean needs ALL
        # of them (shared FS) — barrier, then process 0 writes it (the
        # reference's write_mean on one rank, cwb_letkf.f90:68-71)
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices("cwbnwp-letkf-members-written")
        if cfg.write_analy_mean and jax.process_index() == 0:
            timer.stamp("write analysis mean")
            ens.write_mean(os.path.join(args.output, "wrfout_nc_mean"))
        if args.metrics_json and jax.process_index() != 0:
            args.metrics_json = None   # one metrics file per run
    elif args.stream:
        # member analyses were written per group during the cycle; only the
        # optional mean file remains (read back from the sinks, one field
        # resident at a time)
        if cfg.write_analy_mean:
            timer.stamp("write analysis mean")
            ens.write_mean(os.path.join(args.output, "wrfout_nc_mean"))
    else:
        mean_thread = None
        if cfg.write_analy_mean:
            # overlap the mean write with the member writes — the reference
            # runs them concurrently on disjoint ranks (cwb_letkf.f90:68-77:
            # mean on rank nproc-1 while ranks 0..k-1 write members)
            timer.stamp("write analysis mean (async)")
            import threading

            mean_thread = threading.Thread(
                target=write_mean,
                args=(ens, os.path.join(args.output, "wrfout_nc_mean")))
            mean_thread.start()

        timer.stamp("write analysis ensemble")
        write_ensemble(ens, out_paths)
        if mean_thread is not None:
            mean_thread.join()
    timer.stamp("finish all steps")
    if args.metrics_json:
        with open(args.metrics_json, "w") as fh:
            fh.write(metrics.to_json() + "\n")
    elif not args.quiet:
        print("metrics:", metrics.to_json())
    return 0


if __name__ == "__main__":
    sys.exit(main())
