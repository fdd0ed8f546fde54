"""Smoke run of the renderer's main path on a GPU, in one process.

    python chip_smoke.py              # every phase below, on one card
    python chip_smoke.py --four-gpus  # sharded render + gradient, 4 cards

Phases, in order (each prints one line: its name, lowering + XLA compile
seconds, wall seconds, ``memory_analysis()`` of its step where there is
one, and the process's device ``peak_bytes_in_use`` so far):

1. device       JAX must find a GPU; prints the card's name and power limit.
2. cornell_cli  the batch CLI on the Cornell box, 1024x1024, 16 spp,
                maxDepth 5; the image must be finite, non-negative, red
                wall left, green wall right, mean luminance in band.
3. parity       ``parity_check.run_parity``: the same renders and albedo
                gradient on the GPU and on the in-process CPU backend.
4. grad         one inverse-rendering step (``diff/optimize``) at 1024^2.
5. large        the ~1.1M-triangle scene at 1920x1080, 4 spp, through
                ``render/job.render_film`` (the hierarchy driver).
6. integrators  every integrator the CLI dispatches, 128x128, 2 spp,
                maxDepth 3.

With ``--four-gpus`` only the sharded phases run: the ``-m`` Cornell
render at 1024^2, 4 spp, over four cards against the same code on one,
and one sharded train step at 1024^2 against the single-card gradient.

Every phase runs even when an earlier one failed; any failure makes the
exit code 1.  Only a run in which every phase passed prints its last line,
``{"ok": true, "device": {...}}``.  Each phase is a function of its sizes,
so CPU tests rehearse it small; ``main()`` refuses to run without a GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
LUMA = (0.212671, 0.715160, 0.072169)  # Rec. 709
CORNELL_LUMA_BAND = (0.12, 0.32)  # mean luminance, maxDepth 5
# sharded vs single-card gradient: per-device partial sums are reduced in
# another order (NCCL all-reduce), so agreement is to f32 rounding
GRAD_RTOL = 1e-4

_compile_s = [0.0]


def _on_duration(event, duration, **_kw):
    if event in ("/jax/core/compile/backend_compile_duration",
                 "/jax/core/compile/jaxpr_to_mlir_module_duration"):
        _compile_s[0] += duration


def _fmt_memory(ma) -> str:
    if ma is None:
        return "none"
    return (f"args={ma.argument_size_in_bytes}B "
            f"out={ma.output_size_in_bytes}B temp={ma.temp_size_in_bytes}B "
            f"code={ma.generated_code_size_in_bytes}B")


def _peak_bytes(dev=None):
    import jax

    stats = (dev or jax.devices()[0]).memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def _render_pass_memory(scene, settings):
    """``memory_analysis()`` of the render job's jitted one-spp pass."""
    from mitsuba_im_tpu.render.job import lower_render_pass

    return lower_render_pass(scene, settings).compile().memory_analysis()


def _read_image(path):
    from mitsuba_im_tpu.io.exr import read_exr

    img, _meta = read_exr(path)
    return img


def check_cornell(img) -> dict:
    """Finite, non-negative, red wall left, green wall right, mean
    luminance in ``CORNELL_LUMA_BAND``."""
    import numpy as np

    assert np.isfinite(img).all(), "non-finite pixels"
    assert (img >= 0).all(), "negative pixels"
    w = img.shape[1]
    left = img[:, : w // 8].mean(axis=(0, 1))
    right = img[:, -(w // 8):].mean(axis=(0, 1))
    assert left[0] > left[1] and left[0] > left[2], f"left wall {left}"
    assert right[1] > right[0] and right[1] > right[2], f"right wall {right}"
    luma = float((img[..., :3] * np.asarray(LUMA)).sum(-1).mean())
    lo, hi = CORNELL_LUMA_BAND
    assert lo <= luma <= hi, f"mean luminance {luma} outside {lo}..{hi}"
    return dict(mean_luma=luma)


# ---------------------------------------------------------------------------
# Phases: each returns (info dict, memory_analysis or None)
# ---------------------------------------------------------------------------

def phase_device():
    from mitsuba_im_tpu.runtime import card_info, device_info

    info = device_info()
    print(card_info(), flush=True)
    return info, None


def phase_cornell_cli(workdir, res=1024, spp=16, max_depth=5):
    from mitsuba_im_tpu.cli.main import main as cli_main
    from mitsuba_im_tpu.scene.cornell import write_cornell
    from mitsuba_im_tpu.scene.xml import load_scene

    xml = write_cornell(os.path.join(workdir, "cornell.xml"), res=res,
                        spp=spp, max_depth=max_depth)
    out = os.path.join(workdir, "cornell.exr")
    assert cli_main([xml, "-o", out, "-q"]) == 0, "CLI returned non-zero"
    img = _read_image(out)
    assert img.shape[:2] == (res, res), img.shape
    info = check_cornell(img)
    scene, settings = load_scene(xml)
    return info, _render_pass_memory(scene, settings)


def phase_parity(res=128, large_res=192):
    sys.path.insert(0, HERE)
    from parity_check import run_parity

    par = run_parity(verbose=True, res=res, large_res=large_res)
    bad = [c["name"] for c in par["checks"] if not c["ok"]]
    assert not bad, f"parity failed: {bad}"
    return {c["name"]: f"rel={c['rel']:.2e},p999={c['p999']:.2e},"
                       f"frac_bad={c['frac_bad']:.2e}"
            for c in par["checks"]}, None


def phase_grad(workdir, res=1024, max_depth=5):
    import numpy as np
    import jax
    import jax.numpy as jnp
    from mitsuba_im_tpu.core.types import Float
    from mitsuba_im_tpu.diff.optimize import make_train_step
    from mitsuba_im_tpu.integrators.path import PathConfig
    from mitsuba_im_tpu.scene.cornell import write_cornell
    from mitsuba_im_tpu.scene.xml import load_scene

    xml = write_cornell(os.path.join(workdir, "grad.xml"), res=res, spp=1,
                        max_depth=max_depth)
    scene, settings = load_scene(xml)
    target = jnp.full((res * res, 3), 0.25, Float)
    # PathConfig defaults, with the scene's maxDepth (the default unbounded
    # depth -- 16 bounces -- yields a NaN albedo gradient on every backend)
    cfg = PathConfig(max_depth=settings.integrator_props["max_depth"])
    init, step = make_train_step(scene, settings, cfg, target,
                                 ("bsdf.refl",))
    state = init()
    compiled = step.lower(state, jnp.uint32(0)).compile()
    state2, loss = compiled(state, jnp.uint32(0))
    loss = float(jax.block_until_ready(loss))
    refl = np.asarray(state2.params["bsdf.refl"])
    assert np.isfinite(loss) and loss > 0, f"loss {loss}"
    assert np.isfinite(refl).all(), "non-finite parameters"
    moved = float(np.abs(refl - np.asarray(state.params["bsdf.refl"])).max())
    assert moved > 0, "the step left the parameters unchanged"
    return dict(loss=loss, max_param_step=moved), compiled.memory_analysis()


def phase_large(width=1920, height=1080, spp=4, subdiv=2):
    import numpy as np
    sys.path.insert(0, HERE)
    from bench_scenes import build_large_scene
    from mitsuba_im_tpu.film.film import develop
    from mitsuba_im_tpu.render.job import render_film

    t0 = time.perf_counter()
    scene, settings, n_tris = build_large_scene(width, height, subdiv=subdiv)
    build_s = time.perf_counter() - t0
    img = np.asarray(develop(render_film(scene, settings, spp=spp)))
    assert img.shape == (height, width, 3), img.shape
    assert np.isfinite(img).all() and (img >= 0).all(), "bad pixels"
    assert img.mean() > 0, "black image"
    return (dict(n_tris=n_tris, scene_build_s=round(build_s, 2),
                 mean=float(img.mean())),
            _render_pass_memory(scene, settings))


def _integrator_xml(name, max_depth, chains, photons):
    md = f'<integer name="maxDepth" value="{max_depth}"/>'
    path = f'<integrator type="path">{md}</integrator>'
    body = {
        "path": md, "volpath": md, "ptracer": md, "bdpt": md,
        "direct": "", "ao": "", "vpl": "",
        "sppm": md + f'<integer name="photonCount" value="{photons}"/>',
        "pssmlt": md + f'<integer name="chains" value="{chains}"/>',
        "mlt": md + f'<integer name="chains" value="{chains}"/>',
        "erpt": md + '<integer name="chainLength" value="16"/>',
        "irrcache": path,
        "adaptive": path,
        "multichannel": path + '<integrator type="field"><string '
                               'name="field" value="shapeIndex"/></integrator>',
    }[name]
    return f'<integrator type="{name}">{body}</integrator>'


INTEGRATORS = ("path", "volpath", "direct", "ao", "ptracer", "bdpt", "sppm",
               "pssmlt", "mlt", "erpt", "vpl", "irrcache", "multichannel",
               "adaptive")


def phase_integrators(workdir, res=128, spp=2, max_depth=3, chains=8192,
                      photons=250000, names=INTEGRATORS):
    """Each integrator through the CLI.  maxDepth 3 compiles the same code
    paths as deeper paths in about half the time (the MCMC integrators'
    GPU compiles dominate a cold run)."""
    import numpy as np
    from mitsuba_im_tpu.cli.main import main as cli_main
    from mitsuba_im_tpu.scene.cornell import write_cornell

    info = {}
    for name in names:
        t0, c0 = time.perf_counter(), _compile_s[0]
        xml = write_cornell(
            os.path.join(workdir, f"{name}.xml"), res=res, spp=spp,
            integrator=_integrator_xml(name, max_depth, chains, photons))
        out = os.path.join(workdir, f"{name}.exr")
        assert cli_main([xml, "-o", out, "-q"]) == 0, f"{name}: CLI failed"
        img = _read_image(out)
        assert img.shape[:2] == (res, res), (name, img.shape)
        assert np.isfinite(img).all(), f"{name}: non-finite pixels"
        info[name] = (f"compile_s={_compile_s[0] - c0:.1f},"
                      f"wall_s={time.perf_counter() - t0:.1f},"
                      f"mean={float(img[..., :3].mean()):.4f}")
        print(f"  integrator={name} {info[name]}", flush=True)
    return info, None


def phase_sharded_render(workdir, devices, res=1024, spp=4):
    """``-m`` render over ``devices`` vs the same code on one device."""
    import numpy as np
    from mitsuba_im_tpu.cli.main import main as cli_main
    from mitsuba_im_tpu.parallel.mesh import make_mesh, render_sharded
    from mitsuba_im_tpu.scene.cornell import write_cornell
    from mitsuba_im_tpu.scene.xml import load_scene

    xml = write_cornell(os.path.join(workdir, "sharded.xml"), res=res,
                        spp=spp)
    out = os.path.join(workdir, "sharded.npy")  # float32, unlike half EXR
    assert cli_main([xml, "-o", out, "-q", "-m"]) == 0, "CLI -m failed"
    peaks = [_peak_bytes(d) for d in devices]
    img_n = np.load(out)
    scene, settings = load_scene(xml)
    img_1 = render_sharded(make_mesh(devices[:1]), scene, settings)
    assert np.isfinite(img_n).all(), "non-finite pixels"
    diff = float(np.abs(img_n - img_1).max())
    scale = float(np.abs(img_1).max())
    # each pixel's per-pass delta is non-zero on exactly one device, so
    # the film psum adds exact zeros: expect equality to f32 rounding
    assert diff <= 1e-5 * scale, f"sharded vs one device: max|diff| {diff}"
    if peaks[0] is not None:
        assert min(peaks) > 0.25 * max(peaks), f"uneven device use {peaks}"
    return dict(devices=len(devices), max_abs_diff=diff,
                bitwise=bool(diff == 0.0), peak_bytes_per_device=peaks), None


def phase_sharded_grad(devices, res=1024):
    """One sharded train step vs the single-device gradient."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    sys.path.insert(0, HERE)
    from __graft_entry__ import make_sharded_train_step

    results = []
    for devs in (devices, devices[:1]):
        step, p0, o0 = make_sharded_train_step(devs, res, res)
        compiled = step.lower(p0, o0, jnp.uint32(0)).compile()
        _p, _o, loss, grads = jax.block_until_ready(
            compiled(p0, o0, jnp.uint32(0)))
        results.append((float(loss), jax.tree.map(np.asarray, grads),
                        compiled.memory_analysis()))
    (loss_n, g_n, ma), (loss_1, g_1, _) = results
    rel = max(float(np.abs(g_n[k] - g_1[k]).max()
                    / max(np.abs(g_1[k]).max(), 1e-30)) for k in g_1)
    assert np.isfinite(loss_n), f"loss {loss_n}"
    assert rel <= GRAD_RTOL, f"gradient rel diff {rel} > {GRAD_RTOL}"
    return dict(devices=len(devices), loss=loss_n, loss_one=loss_1,
                grad_max_rel=rel, bitwise=bool(rel == 0.0)), ma


# ---------------------------------------------------------------------------

def _run_phase(name, fn, *args, **kw) -> bool:
    t0, c0 = time.perf_counter(), _compile_s[0]
    try:
        info, ma = fn(*args, **kw)
        ok = True
    except Exception:
        traceback.print_exc()
        info, ma, ok = {}, None, False
    extra = " ".join(f"{k}={v}" for k, v in info.items())
    print(f"phase={name} ok={ok} compile_s={_compile_s[0] - c0:.1f} "
          f"wall_s={time.perf_counter() - t0:.1f} "
          f"memory_analysis=[{_fmt_memory(ma)}] "
          f"peak_bytes_in_use={_peak_bytes()} {extra}", flush=True)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the sharded render + gradient on 4 cards")
    args = ap.parse_args(argv)

    sys.path.insert(0, HERE)
    from mitsuba_im_tpu.runtime import (device_info, enable_compile_cache,
                                        require_gpu)

    devices = require_gpu("chip_smoke.py")
    enable_compile_cache()
    import jax

    jax.monitoring.register_event_duration_secs_listener(_on_duration)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_", dir=HERE)
    phases = [("device", phase_device, (), {})]
    if args.four_gpus:
        if len(devices) < 4:
            raise SystemExit(f"chip_smoke.py: --four-gpus needs 4 GPUs, "
                             f"JAX found {len(devices)}")
        phases += [
            ("sharded_render", phase_sharded_render, (workdir, devices[:4]),
             {}),
            ("sharded_grad", phase_sharded_grad, (devices[:4],), {}),
        ]
    else:
        phases += [
            ("cornell_cli", phase_cornell_cli, (workdir,), {}),
            ("parity", phase_parity, (), {}),
            ("grad", phase_grad, (workdir,), {}),
            ("large", phase_large, (), {}),
            ("integrators", phase_integrators, (workdir,), {}),
        ]
    try:
        failed = [name for name, fn, a, kw in phases
                  if not _run_phase(name, fn, *a, **kw)]
    finally:
        import shutil

        shutil.rmtree(workdir, ignore_errors=True)
    if failed:
        print(f"chip_smoke.py: failed phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": device_info()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
