"""Batch render CLI — the ``mitsuba`` executable surface
(``/root/reference/src/mitsuba/mitsuba.cpp:51-88`` flag set).

Supported: scene args with -D key=value substitution, -o output, -s spp
override, -t thread/device info, -r periodic flush, -S progressive dumps,
-x skip-if-exists, -j pipelined scene builds, -c checkpoint,
-z resume, -q/-v verbosity, -i interactive/progressive mode.
Cluster flags (-c host lists) are replaced by the JAX distributed runtime
(see parallel/): multi-chip needs no bespoke transport.

Usage: python -m mitsuba_im_tpu scene.xml [options]
"""
from __future__ import annotations

import argparse
import os
import sys
import time


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="mitsuba-tpu", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("scenes", nargs="+", help="scene XML file(s)")
    ap.add_argument("-D", dest="defines", action="append", default=[],
                    metavar="key=value", help="scene parameter substitution")
    ap.add_argument("-o", dest="output", default=None,
                    help="output file (default: scene name + .exr)")
    ap.add_argument("-s", dest="spp", type=int, default=None, help="override spp")
    ap.add_argument("-r", dest="flush_sec", type=float, default=0,
                    help="write partial image every N seconds")
    ap.add_argument("-S", dest="progressive", type=int, default=0,
                    metavar="N", help="write a numbered image every N spp")
    ap.add_argument("-x", dest="skip_existing", action="store_true",
                    help="skip scenes whose output already exists")
    ap.add_argument("-c", dest="checkpoint", default=None,
                    help="write a resume checkpoint alongside the render")
    ap.add_argument("-z", dest="resume", default=None,
                    help="resume from a checkpoint file")
    ap.add_argument("-m", dest="multichip", action="store_true",
                    help="shard the render across all visible devices")
    ap.add_argument("--nodes", dest="nodes", default=None,
                    help="semicolon-separated render nodes: host[:port] or "
                         "'exec:CMD' (e.g. exec:ssh host python -m "
                         "mitsuba_im_tpu.cli.mtssrv -ls); the -c cluster "
                         "flag analog (mitsuba.cpp:71-73).  Each exec: node "
                         "is a new JAX process: a local one on a one-GPU "
                         "host fails for want of device memory while this "
                         "process also renders (--local-worker), so point "
                         "exec: at other hosts or pass --no-local-worker")
    ap.add_argument("--local-worker", dest="local_worker",
                    action=argparse.BooleanOptionalAction, default=True,
                    help="with --nodes: also render on this process")
    ap.add_argument("-j", dest="jobs", type=int, default=1,
                    help="scene-build pipelining depth: load the next "
                         "scenes on host threads while the device renders "
                         "(mitsuba.cpp -j analog; device passes stay "
                         "serialized in this one process)")
    ap.add_argument("-q", dest="quiet", action="store_true")
    ap.add_argument("-v", dest="verbose", action="store_true")
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    return ap


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    from ..runtime import enable_compile_cache

    enable_compile_cache()
    params = {}
    for d in args.defines:
        if "=" not in d:
            raise SystemExit(f"bad -D argument '{d}' (expected key=value)")
        k, v = d.split("=", 1)
        params[k] = v

    from ..scene.xml import load_scene
    from ..render.job import render_film, develop, save_render, FILM_INTEGRATORS
    from ..film.film import make_film
    from ..core import statistics as stats
    from ..core.logger import add_stream_appender, set_log_level, EDebug, EInfo
    import numpy as np

    add_stream_appender(level=EDebug if args.verbose else EInfo)
    if args.verbose:
        set_log_level(EDebug)

    rc = 0
    loader = None
    if args.jobs > 1 and len(args.scenes) > 1:
        from concurrent.futures import ThreadPoolExecutor

        pool = ThreadPoolExecutor(max_workers=max(args.jobs - 1, 1))
        futures = {p: pool.submit(load_scene, p, params)
                   for p in args.scenes}
        loader = futures.get
    for scene_path in args.scenes:
        out = args.output or os.path.splitext(scene_path)[0] + ".exr"
        if args.skip_existing and os.path.exists(out):
            if not args.quiet:
                print(f"[skip] {out} exists")
            continue
        t0 = time.time()
        if loader is not None and loader(scene_path) is not None:
            scene, settings = loader(scene_path).result()
        else:
            scene, settings = load_scene(scene_path, params)
        if args.spp:
            settings.spp = args.spp
        if args.width:
            settings.width = args.width
        if args.height:
            settings.height = args.height
        if not args.quiet:
            print(f"[load] {scene_path}: {scene.geom.n_tris} tris, "
                  f"{scene.emitters.n_emitters} emitters, "
                  f"{settings.width}x{settings.height}@{settings.spp}spp "
                  f"integrator={settings.integrator} ({time.time()-t0:.2f}s)",
                  flush=True)

        film = None
        start_spp = 0
        if args.resume:
            from ..interactive.checkpoint import load_checkpoint

            film, start_spp, _ = load_checkpoint(args.resume)
            if not args.quiet:
                print(f"[resume] {start_spp} spp from {args.resume}")

        last_flush = [time.time()]

        def progress(done, total, film_now):
            if not args.quiet:
                sys.stdout.write(f"\r[render] {done + start_spp}/{total + start_spp} spp")
                sys.stdout.flush()
            if args.flush_sec and time.time() - last_flush[0] > args.flush_sec:
                save_render(out, np.asarray(develop(film_now)), settings,
                            metadata={"spp": str(done + start_spp)})
                last_flush[0] = time.time()
            if args.progressive and (done % args.progressive == 0):
                base, ext = os.path.splitext(out)
                save_render(f"{base}_{done + start_spp:05d}{ext}",
                            np.asarray(develop(film_now)), settings)
            if args.checkpoint:
                from ..interactive.checkpoint import save_checkpoint

                save_checkpoint(args.checkpoint, film_now, done + start_spp, settings)

        t1 = time.time()
        if args.nodes:
            from ..parallel.remote import render_distributed

            img = render_distributed(
                scene, settings, args.nodes.split(";"),
                include_local=args.local_worker,
                log=(lambda *_: None) if args.quiet else
                    (lambda *a: print(*a, flush=True)))
        elif settings.integrator not in FILM_INTEGRATORS:
            from ..render.job import render as _render

            img = _render(scene, settings)
        elif args.multichip:
            from ..parallel.mesh import make_mesh, render_sharded

            img = render_sharded(make_mesh(), scene, settings)
        elif getattr(settings, "tiled", False) and out.endswith(".exr"):
            from ..film.tiled import render_tiled

            render_tiled(scene, settings, out, spp=settings.spp,
                         metadata={"renderer": "mitsuba_im_tpu"})
            wall = time.time() - t1
            if not args.quiet:
                print(f"[done] {out}  {wall:.2f}s (tiled out-of-core)")
            continue
        else:
            film = render_film(scene, settings, spp=settings.spp - start_spp,
                               film=film, sample_offset=start_spp,
                               progress_cb=progress)
            img = np.asarray(develop(film))
        wall = time.time() - t1
        save_render(out, img, settings, metadata={
            "renderTime": f"{wall:.3f}s",
            "renderer": "mitsuba_im_tpu",
        })
        if not args.quiet:
            n_paths = settings.width * settings.height * settings.spp
            rate = n_paths / max(wall, 1e-9)
            print(f"\n[done] {out}  {wall:.2f}s "
                  f"({rate / 1e6:.2f} Mpaths/s)", flush=True)
        if args.verbose:
            stats.record("General", "Render time (s)", wall)
            stats.print_stats()
    return rc


if __name__ == "__main__":
    sys.exit(main())
