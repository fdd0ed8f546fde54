"""Benchmark: wavefront path-tracer throughput on one GPU.

    python bench.py

Prints the card's name and power limit, then ONE JSON line: top-level keys
{"metric", "value", "unit", "vs_baseline"} carry the Cornell-box forward
rate (BASELINE north star 1e9 rays/s per device), ``device`` names the
device JAX ran on, and the ``metrics`` array also records the fwd+bwd
(path-replay backprop) rate, a ~1.1M-triangle scene at 1920x1080 and the
device-vs-CPU render parity check.

Timing: host clock around one pass that ends in ``block_until_ready``;
the median of ``REPEATS`` warm passes, with their min and max.  Exits
non-zero without a GPU, and when any cell raised.
"""
from __future__ import annotations

import json
import os
import statistics
import sys
import time

REPEATS = 5


def _time_pass(run, scene, rays_per_pass):
    """Compile + warm once, then time ``REPEATS`` passes; rays/s stats."""
    import jax
    import jax.numpy as jnp

    t0 = time.perf_counter()
    jax.block_until_ready(run(scene, jnp.uint32(0)))
    compile_s = time.perf_counter() - t0
    times = []
    for k in range(REPEATS):
        t0 = time.perf_counter()
        jax.block_until_ready(run(scene, jnp.uint32(k + 1)))
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    return dict(value=rays_per_pass / med, unit="rays/s",
                pass_s_median=med, pass_s_min=min(times),
                pass_s_max=max(times), repeats=REPEATS,
                first_call_s=compile_s)


def _camera_pass(scene, W, H, cfg, sample_idx):
    import jax.numpy as jnp
    from mitsuba_im_tpu.core import rng as mrng
    from mitsuba_im_tpu.core.types import Float
    from mitsuba_im_tpu.integrators.path import path_li_v
    from mitsuba_im_tpu.sensor.table import sample_ray_v

    n = W * H
    pix = jnp.arange(n, dtype=jnp.uint32)
    sampler = mrng.make_sampler_v(pix, sample_idx, jnp.uint32(0))
    sampler, blk0 = mrng.next_block4_v(sampler)
    uu = ((pix % W).astype(Float) + blk0[0]) / W
    vv = ((pix // W).astype(Float) + blk0[1]) / H
    o, d, _w = sample_ray_v(scene.sensor, uu, vv, blk0[2], blk0[3])
    li, _ = path_li_v(scene, sampler, o, d, cfg)
    return li.sum().sum()


def bench_forward():
    import jax
    from __graft_entry__ import _tiny_cornell
    from mitsuba_im_tpu.integrators.path import PathConfig

    scene, _settings = _tiny_cornell()
    max_depth = 5
    # forward-only render: rematerialization only pays off under grad
    cfg = PathConfig(max_depth=max_depth, remat=False)
    W = H = 1024
    run = jax.jit(lambda s, k: _camera_pass(s, W, H, cfg, k))
    return _time_pass(run, scene, W * H * (1 + 2 * (max_depth - 1)))


def bench_fwdbwd():
    """fwd+bwd (path-replay backprop) rate; rays counted = forward-pass
    queries so the figure reads directly as grad overhead vs forward."""
    import jax
    from __graft_entry__ import _tiny_cornell
    from mitsuba_im_tpu.integrators.path import PathConfig

    scene, _settings = _tiny_cornell()
    max_depth = 5
    # remat_group=4: ONE checkpoint unit around the whole bounce loop, so
    # the backward pass replays the wavefront once instead of once per
    # bounce (gradients bitwise identical to per-bounce remat)
    cfg = PathConfig(max_depth=max_depth, remat=True, remat_group=4)
    W = H = 1024

    def loss(refl, scene, k):
        scene = scene.replace(bsdfs=scene.bsdfs.replace(refl=refl))
        return _camera_pass(scene, W, H, cfg, k)

    grad = jax.grad(loss)
    run = jax.jit(lambda s, k: grad(s.bsdfs.refl, s, k).sum())
    return _time_pass(run, scene, W * H * (1 + 2 * (max_depth - 1)))


def bench_large_scene():
    """BASELINE config 4 regime: ~1.1M-triangle mesh under an environment
    emitter at 1920x1080, forward path tracing through the hierarchy."""
    import jax
    from bench_scenes import build_large_scene
    from mitsuba_im_tpu.integrators.path import PathConfig

    scene, settings, n_tris = build_large_scene(1920, 1080)
    max_depth = settings.integrator_props["max_depth"]
    cfg = PathConfig(max_depth=max_depth, remat=False)
    W, H = settings.width, settings.height
    run = jax.jit(lambda s, k: _camera_pass(s, W, H, cfg, k))
    out = _time_pass(run, scene, W * H * (1 + 2 * (max_depth - 1)))
    out.update(n_tris=n_tris, width=W, height=H)
    return out


def bench_parity():
    from parity_check import run_parity

    par = run_parity(verbose=False)
    grad = [c for c in par["checks"] if c["name"] == "grad_albedo"]
    return dict(value=1.0 if par["ok"] else 0.0, unit="bool",
                max_rel=max(c["rel"] for c in par["checks"]),
                pixel_p999=max(c["p999"] for c in par["checks"]),
                pixel_frac_bad=max(c["frac_bad"] for c in par["checks"]),
                grad_max_rel=grad[0]["rel"] if grad else None)


# ---------------------------------------------------------------------------
# Trace probe (--probe): device-time shares from a profiler trace
# ---------------------------------------------------------------------------

def _kernel_events(trace_dir):
    """(start_ns, end_ns, hlo_op) of every kernel on the GPU streams."""
    import glob
    from jax.profiler import ProfileData

    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    events = []
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for e in line.events:
                stats = dict(e.stats)
                events.append((e.start_ns, e.start_ns + e.duration_ns,
                               stats.get("hlo_op", e.name)))
    return events


def _op_scopes(hlo_text):
    """HLO instruction name -> (its own op_name, the op_names of every
    instruction fused into it); op_names carry the named-scope path."""
    import re

    inst = re.compile(r'^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(.*)$')
    comp = re.compile(r'^\s*(?:ENTRY\s+)?%?([\w.\-]+)\s.*\{\s*$')
    opname = re.compile(r'op_name="([^"]*)"')
    calls = re.compile(r'calls=%?([\w.\-]+)')
    own, called, members, cur = {}, {}, {}, None
    for line in hlo_text.splitlines():
        m = inst.match(line)
        if m and cur is not None:
            name, rest = m.groups()
            o = opname.search(rest)
            own[name] = o.group(1) if o else ""
            members[cur].append(own[name])
            c = calls.search(rest)
            if c:
                called[name] = c.group(1)
            continue
        m = comp.match(line)
        if m:
            cur = m.group(1)
            members[cur] = []
    return {n: (own[n], set(members.get(called.get(n), ())) | {own[n]})
            for n in own}


def reduce_trace(events, scopes, names=("closest_hit", "any_hit"), top=12):
    """Device busy time, idle share of the traced window, each named
    scope's share of kernel time, and the ``top`` kernels by time.

    ``{name}_share`` counts kernels whose root op is in the span (a lower
    bound: XLA may fuse a span into a consumer outside it);
    ``{name}_touch_share`` counts kernels with any fused op in it (an
    upper bound)."""
    if not events:
        return dict(kernels=0)
    ev = sorted(events)
    busy, cur_s, cur_e = 0.0, ev[0][0], ev[0][1]
    for s, e, _ in ev[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = max(e for _, e, _ in ev) - ev[0][0]
    total = sum(e - s for s, e, _ in ev)
    out = dict(kernels=len(ev), window_ms=window / 1e6, busy_ms=busy / 1e6,
               idle_share=1.0 - busy / window, kernel_ms=total / 1e6)
    none = ("", set())
    for n in names:
        tag = f"/{n}/"
        root = sum(e - s for s, e, op in ev
                   if tag in scopes.get(op, none)[0])
        touch = sum(e - s for s, e, op in ev
                    if any(tag in x for x in scopes.get(op, none)[1]))
        out[f"{n}_ms"] = root / 1e6
        out[f"{n}_share"] = root / total
        out[f"{n}_touch_ms"] = touch / 1e6
        out[f"{n}_touch_share"] = touch / total
    per_op = {}
    for s, e, op in ev:
        per_op[op] = per_op.get(op, 0) + e - s
    out["top_kernels"] = [
        (op, round(t / 1e6, 4), scopes.get(op, none)[0][-80:])
        for op, t in sorted(per_op.items(), key=lambda kv: -kv[1])[:top]]
    return out


def _trace_passes(scene, settings, n_pass, trace_dir):
    """Trace ``n_pass`` render-job passes of an already warm program."""
    import jax
    import jax.numpy as jnp
    from mitsuba_im_tpu.film.film import make_film
    from mitsuba_im_tpu.render.job import lower_render_pass

    compiled = lower_render_pass(scene, settings).compile()
    data = make_film(settings.width, settings.height, settings.rfilter,
                     settings.rfilter_radius).data
    seed = jnp.uint32(settings.seed)
    data = jax.block_until_ready(compiled(scene, data, jnp.uint32(0), seed))
    t0 = time.perf_counter()
    with jax.profiler.trace(trace_dir):
        for k in range(n_pass):
            data = compiled(scene, data, jnp.uint32(k + 1), seed)
        jax.block_until_ready(data)
    wall = time.perf_counter() - t0
    out = reduce_trace(_kernel_events(trace_dir),
                       _op_scopes(compiled.as_text()))
    out.update(passes=n_pass, traced_wall_ms=wall * 1e3)
    return out


def _rate(fn, *args, repeats=REPEATS):
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times), min(times), max(times)


def cornell_intersection_cost():
    """Standalone brute-force intersection at the Cornell forward cell's
    wavefront (1024^2 rays from inside the box): the time one pass's 5
    closest-hit and 4 any-hit calls would take unfused, beside the pass."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from __graft_entry__ import _tiny_cornell
    from mitsuba_im_tpu.core.v3 import V3

    scene, _ = _tiny_cornell()
    n = 1024 * 1024
    rng = np.random.default_rng(0)
    o = rng.uniform([-0.9, 0.1, -0.9], [0.9, 1.9, 0.9], (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = V3.from_array(jnp.asarray(o, jnp.float32))
    d = V3.from_array(jnp.asarray(d, jnp.float32))
    closest = jax.jit(lambda o, d: scene.ray_intersect_v(o, d))
    anyhit = jax.jit(lambda o, d: scene.occluded_v(o, d, 1e-4, 1.5))
    t_c = _rate(closest, o, d)[0]
    t_a = _rate(anyhit, o, d)[0]
    fwd = bench_forward()["pass_s_median"]
    est = 5 * t_c + 4 * t_a
    return dict(closest_s=t_c, any_s=t_a, pass_s=fwd, per_pass_s=est,
                share=est / fwd)


def probe(outdir):
    """Intersection's share of the Cornell pass, the large-scene pass's
    idle share, and hierarchy vs threaded-BVH closest-hit rates."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from bench_scenes import build_large_scene
    from mitsuba_im_tpu.accel.hierarchy import PROLOGUE, intersect_hierarchy
    from mitsuba_im_tpu.accel.intersect import intersect_bvh
    from mitsuba_im_tpu.scene.cornell import write_cornell
    from mitsuba_im_tpu.scene.xml import load_scene
    from mitsuba_im_tpu.sensor.table import sample_ray

    os.makedirs(outdir, exist_ok=True)
    xml = write_cornell(os.path.join(outdir, "cornell.xml"), res=1024,
                        spp=16, max_depth=5)
    scene, settings = load_scene(xml)
    res = dict(cornell_pass=_trace_passes(
        scene, settings, 4, os.path.join(outdir, "trace_cornell")))
    print(json.dumps(res), flush=True)

    scene, settings, n_tris = build_large_scene(1920, 1080)
    res["large_pass"] = _trace_passes(scene, settings, 2,
                                      os.path.join(outdir, "trace_large"))
    print(json.dumps(res["large_pass"]), flush=True)

    # closest hit on the large scene: camera rays, then diffuse-bounce rays
    W, H = settings.width, settings.height
    pix = np.arange(W * H)
    uv = np.stack([(pix % W + 0.5) / W, (pix // W + 0.5) / H], -1)
    o, d, _ = sample_ray(scene.sensor, jnp.asarray(uv, jnp.float32),
                         jnp.zeros((W * H, 2), jnp.float32))
    n = o.shape[0]
    tmax = jnp.full((n,), 1e30, jnp.float32)
    hier = jax.jit(lambda o, d, pro: intersect_hierarchy(
        scene.clusters, o, d, 1e-4, 1e30, prologue=pro), static_argnums=2)
    bvh = jax.jit(lambda o, d: intersect_bvh(scene.bvh, scene.geom, o, d,
                                             1e-4, tmax))
    first = hier(o, d, PROLOGUE)
    p = o + d * jnp.where(first["found"], first["t"], 0.0)[:, None]
    rnd = jax.random.normal(jax.random.PRNGKey(0), (n, 3))
    d2 = rnd / jnp.linalg.norm(rnd, axis=1, keepdims=True)
    rates = {}
    for name, (oo, dd, pro) in dict(camera=(o, d, PROLOGUE),
                                    bounce=(p, d2, 0)).items():
        for algo, fn in (("hierarchy", lambda a, b: hier(a, b, pro)),
                         ("bvh", bvh)):
            med, lo, hi = _rate(fn, oo, dd)
            rates[f"{name}_{algo}"] = dict(rays_per_s=n / med, s_median=med,
                                           s_min=lo, s_max=hi)
    res["closest_hit_rates"] = dict(rays=n, n_tris=n_tris, **rates)
    print(json.dumps(res["closest_hit_rates"]), flush=True)
    return res


CELLS = (
    ("device_cpu_render_parity", bench_parity),
    ("cornell_path_rays_per_sec", bench_forward),
    ("cornell_path_fwdbwd_rays_per_sec", bench_fwdbwd),
    ("large_scene_rays_per_sec", bench_large_scene),
)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--probe", metavar="DIR", default=None,
                    help="instead of the cells: trace the Cornell and the "
                         "large-scene passes into DIR and report device-time "
                         "shares and closest-hit rates (XLA's command "
                         "buffers hide single kernels from the trace: set "
                         "XLA_FLAGS=--xla_gpu_enable_command_buffer= for "
                         "the span shares)")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mitsuba_im_tpu.runtime import (card_info, device_info,
                                        enable_compile_cache, require_gpu)

    require_gpu("bench.py")
    enable_compile_cache()
    print(card_info(), flush=True)
    if args.probe:
        res = probe(args.probe)
        print(json.dumps(dict(probe=res, device=device_info())))
        return 0
    metrics, failed = [], []
    for name, cell in CELLS:
        try:
            metrics.append(dict(metric=name, **cell()))
        except Exception as e:  # report every cell, then fail the run
            failed.append(name)
            metrics.append(dict(metric=name, error=repr(e)[:400]))
        print(json.dumps(metrics[-1]), file=sys.stderr, flush=True)
    if metrics[0].get("value") == 0.0:
        failed.append(metrics[0]["metric"])
    fwd = next(m for m in metrics if m["metric"] == CELLS[1][0])
    print(json.dumps(dict(
        metric=fwd["metric"], value=fwd.get("value"), unit="rays/s",
        vs_baseline=fwd["value"] / 1e9 if "value" in fwd else None,
        device=device_info(), metrics=metrics, failed=failed,
    )))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
