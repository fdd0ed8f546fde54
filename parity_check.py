"""Device-vs-CPU render parity check.

Renders fixed scenes with a fixed seed on the default device (the GPU)
AND on the in-process CPU backend, and requires the results to agree.
Tests run on the CPU, so this is what catches a device-only correctness
bug: a miscompile, a nondeterministic scatter, a reduced-precision matrix
product.  One process, one card: the CPU leg uses the same process.

Run standalone (``python parity_check.py``), or as phase 3 of
``chip_smoke.py``.

Checks cover the distinct execution regimes, each gated PER PIXEL
(99.9th-percentile relative error + bad-pixel fraction -- a sum check
would pass a device-only bug that merely *redistributes* energy between
pixels) plus one gradient check (d sum(image) / d albedo, device vs CPU),
so the differentiable path has an on-device correctness gate:
- Cornell wavefront path tracer (brute-force intersection);
- the skip_direct peeled-bounce variant;
- reverse-mode path-replay gradients w.r.t. the BSDF albedo table;
- a 70k-triangle mesh at a resolution that engages the hierarchy's
  compaction driver (N > FRONT) on the device, against the threaded BVH
  walk on the CPU.

Analog of the reference's cross-check discipline (SURVEY §4.4: the
reference validates sampling vs pdf and runs scene regression renders;
here the "other implementation" is the same code on a second backend).
"""
from __future__ import annotations

import os
import sys


RTOL = 5e-3  # f32 reduction-order drift across backends is ~1e-6..1e-4;
             # a redistribution bug moves whole regions (~1e-1).  5e-3
             # leaves two orders of margin on both sides.


def _render_cornell(scene, n, W, H, device, skip_direct=False):
    """Per-pixel luminance image (numpy (n,)) on the given backend."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from mitsuba_im_tpu.core import rng as mrng
    from mitsuba_im_tpu.core.types import Float
    from mitsuba_im_tpu.integrators.path import PathConfig, path_li_v
    from mitsuba_im_tpu.sensor.table import sample_ray_v

    cfg = PathConfig(max_depth=5, remat=False, skip_direct=skip_direct)

    def run(scene):
        pix = jnp.arange(n, dtype=jnp.uint32)
        sampler = mrng.make_sampler_v(pix, jnp.uint32(7), jnp.uint32(0))
        sampler, blk0 = mrng.next_block4_v(sampler)
        uu = ((pix % W).astype(Float) + blk0[0]) / W
        vv = ((pix // W).astype(Float) + blk0[1]) / H
        o, d, _w = sample_ray_v(scene.sensor, uu, vv, blk0[2], blk0[3])
        li, _ = path_li_v(scene, sampler, o, d, cfg)
        return li.x + li.y + li.z

    scene_d = jax.device_put(scene, device)
    with jax.default_device(device):
        return np.asarray(jax.jit(run)(scene_d))


def _grad_cornell(scene, n, W, H, device):
    """d(sum li)/d(albedo table) — the differentiable path on a backend."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from mitsuba_im_tpu.core import rng as mrng
    from mitsuba_im_tpu.core.types import Float
    from mitsuba_im_tpu.integrators.path import PathConfig, path_li_v
    from mitsuba_im_tpu.sensor.table import sample_ray_v

    cfg = PathConfig(max_depth=5, remat=True)

    def loss(refl, scene):
        scene = scene.replace(bsdfs=scene.bsdfs.replace(refl=refl))
        pix = jnp.arange(n, dtype=jnp.uint32)
        sampler = mrng.make_sampler_v(pix, jnp.uint32(7), jnp.uint32(0))
        sampler, blk0 = mrng.next_block4_v(sampler)
        uu = ((pix % W).astype(Float) + blk0[0]) / W
        vv = ((pix // W).astype(Float) + blk0[1]) / H
        o, d, _w = sample_ray_v(scene.sensor, uu, vv, blk0[2], blk0[3])
        li, _ = path_li_v(scene, sampler, o, d, cfg)
        return li.sum().sum()

    scene_d = jax.device_put(scene, device)
    with jax.default_device(device):
        g = jax.jit(jax.grad(loss))(scene_d.bsdfs.refl, scene_d)
        return np.asarray(g)


def _pix_stats(a, b):
    """Per-pixel relative agreement stats between two luminance images."""
    import numpy as np

    scale = max(float(np.abs(b).mean()), 1e-12)
    rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-2 * scale)
    return dict(
        max_rel=float(rel.max()),
        p999=float(np.quantile(rel, 0.999)),
        frac_bad=float((rel > 1e-3).mean()),
    )


def run_parity(verbose=True, res=128, large_res=192):
    """Returns dict(ok, checks=[{name, device, cpu, rel, ...}]).

    ``res``: Cornell image side; ``large_res``: side of the mesh render
    (192^2 = 36864 rays > FRONT engages the compaction driver)."""
    import jax

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from __graft_entry__ import _tiny_cornell
    from bench_scenes import build_large_scene

    import numpy as np

    default_dev = jax.devices()[0]
    cpu_dev = jax.devices("cpu")[0]
    checks = []

    def compare(name, dev_img, cpu_img):
        dev_v = float(dev_img.sum())
        cpu_v = float(cpu_img.sum())
        rel = abs(dev_v - cpu_v) / max(abs(cpu_v), 1e-30)
        st = _pix_stats(dev_img, cpu_img)
        # per-pixel gate: f32 reduction drift is ~1e-6..1e-4 per pixel,
        # but backend op-order differences can flip a rare hit/miss edge
        # branch on isolated pixels -- gate the 99.9th percentile and the
        # bad-pixel FRACTION instead of the absolute max (a redistribution
        # bug moves whole image regions and blows frac_bad immediately; a
        # flipped seam pixel does not)
        ok = rel < RTOL and st["p999"] < 1e-3 and st["frac_bad"] < 2e-3
        checks.append(dict(name=name, device=dev_v, cpu=cpu_v, rel=rel,
                           ok=ok, **st))

    # --- Cornell wavefront regime -------------------------------------
    scene, _ = _tiny_cornell()
    W = H = res
    compare("cornell",
            _render_cornell(scene, W * H, W, H, default_dev),
            _render_cornell(scene, W * H, W, H, cpu_dev))

    # --- skip_direct (separate-direct MCMC) regime --------------------
    # a traced per-depth mask in the bounce loop once miscompiled under
    # whole-program jit on an accelerator only; the fix peels the first
    # bounce -- this render pins the class
    compare("skip_direct",
            _render_cornell(scene, W * H, W, H, default_dev,
                            skip_direct=True),
            _render_cornell(scene, W * H, W, H, cpu_dev, skip_direct=True))

    # --- gradient parity ----------------------------------------------
    g_dev = _grad_cornell(scene, W * H, W, H, default_dev)
    g_cpu = _grad_cornell(scene, W * H, W, H, cpu_dev)
    gscale = max(float(np.abs(g_cpu).max()), 1e-12)
    grel = float(np.abs(g_dev - g_cpu).max() / gscale)
    checks.append(dict(name="grad_albedo", device=float(g_dev.sum()),
                       cpu=float(g_cpu.sum()), rel=grel, ok=grel < RTOL,
                       max_rel=grel, p999=grel, frac_bad=0.0))

    # --- large-scene regime: hierarchy driver vs the CPU BVH walk ------
    scene, settings, _n = build_large_scene(large_res, subdiv=0)
    W, H = settings.width, settings.height
    compare("large_scene_driver",
            _render_cornell(scene, W * H, W, H, default_dev),
            _render_cornell(scene, W * H, W, H, cpu_dev))

    ok = all(c["ok"] for c in checks)
    if verbose:
        for c in checks:
            flag = "OK " if c["ok"] else "FAIL"
            print(f"[{flag}] {c['name']}: device={c['device']:.6e} "
                  f"cpu={c['cpu']:.6e} rel={c['rel']:.2e} "
                  f"p999={c['p999']:.2e} frac_bad={c['frac_bad']:.2e}")
    return dict(ok=ok, checks=checks)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mitsuba_im_tpu.runtime import enable_compile_cache

    enable_compile_cache()
    r = run_parity()
    sys.exit(0 if r["ok"] else 1)
