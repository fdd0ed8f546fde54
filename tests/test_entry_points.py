"""The GPU entry points on the CPU: ``chip_smoke.py``'s phases rehearsed
at tiny sizes, the device checks that refuse a CPU run, the compile-cache
placement, and the device-vs-CPU parity check (on a card only)."""
import os

import jax
import pytest

import bench
import chip_smoke
from mitsuba_im_tpu import runtime


def test_chip_smoke_refuses_cpu():
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert "needs a GPU" in str(e.value.code) and "cpu" in str(e.value.code)


def test_bench_refuses_cpu():
    with pytest.raises(SystemExit) as e:
        bench.main([])
    assert "needs a GPU" in str(e.value.code) and "cpu" in str(e.value.code)


def test_compile_cache_leaves_env_dir_alone(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert runtime.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


@pytest.mark.parametrize("backend", ["gpu", "cpu"])
def test_compile_cache_fixed_path(monkeypatch, backend):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    before = jax.config.jax_compilation_cache_dir
    try:
        got = runtime.enable_compile_cache()
        if backend == "gpu":
            repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
            assert got == os.path.join(repo, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == got
        else:  # CPU-only processes keep no persistent cache
            assert got is None
            assert jax.config.jax_compilation_cache_dir == before
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_rehearse_cornell_cli(tmp_path):
    info, ma = chip_smoke.phase_cornell_cli(str(tmp_path), res=32, spp=4)
    lo, hi = chip_smoke.CORNELL_LUMA_BAND
    assert lo <= info["mean_luma"] <= hi
    assert ma.temp_size_in_bytes > 0


def test_rehearse_parity():
    info, _ = chip_smoke.phase_parity(res=16, large_res=16)
    assert set(info) == {"cornell", "skip_direct", "grad_albedo",
                         "large_scene_driver"}


def test_rehearse_grad(tmp_path):
    info, ma = chip_smoke.phase_grad(str(tmp_path), res=16)
    assert info["loss"] > 0 and info["max_param_step"] > 0
    assert ma is not None


def test_rehearse_large():
    info, _ = chip_smoke.phase_large(width=24, height=16, spp=1, subdiv=0)
    assert info["n_tris"] > 512  # past brute force: the accelerator path


def test_rehearse_sharded_render(tmp_path):
    info, _ = chip_smoke.phase_sharded_render(str(tmp_path), jax.devices(),
                                              res=16, spp=2)
    assert info["devices"] == len(jax.devices()) > 1


def test_rehearse_sharded_grad():
    info, _ = chip_smoke.phase_sharded_grad(jax.devices()[:4], res=16)
    assert info["devices"] == 4
    assert info["grad_max_rel"] <= chip_smoke.GRAD_RTOL


@pytest.mark.gpu
def test_device_cpu_parity(gpu_device):
    """The GPU against the in-process CPU backend (chip_smoke's phase 3)."""
    from parity_check import run_parity

    par = run_parity(verbose=True, res=64, large_res=96)
    assert par["ok"], par["checks"]


def test_reduce_trace_busy_idle_and_scopes():
    ev = [(0, 10, "a"), (5, 20, "b"), (30, 40, "c")]
    scopes = {"a": ("jit(f)/closest_hit/min", {"jit(f)/closest_hit/min"}),
              "b": ("jit(f)/mul", {"jit(f)/mul", "jit(f)/any_hit/or"}),
              "c": ("jit(f)/any_hit/or", {"jit(f)/any_hit/or"})}
    r = bench.reduce_trace(ev, scopes)
    assert r["busy_ms"] * 1e6 == 30 and r["window_ms"] * 1e6 == 40
    assert abs(r["idle_share"] - 0.25) < 1e-12
    assert abs(r["closest_hit_share"] - 10 / 35) < 1e-12
    assert abs(r["any_hit_share"] - 10 / 35) < 1e-12
    assert abs(r["any_hit_touch_share"] - 25 / 35) < 1e-12


def test_op_scopes_find_the_intersection_spans():
    from mitsuba_im_tpu.render.job import lower_render_pass
    from mitsuba_im_tpu.scene.cornell import cornell_xml
    from mitsuba_im_tpu.scene.xml import load_scene

    import tempfile

    with tempfile.NamedTemporaryFile("w", suffix=".xml", delete=False) as f:
        f.write(cornell_xml(res=8, spp=1, max_depth=3))
    scene, settings = load_scene(f.name)
    os.unlink(f.name)
    scopes = bench._op_scopes(lower_render_pass(scene, settings)
                              .compile().as_text())
    roots = {own for own, _ in scopes.values()}
    fused = set().union(*(inner for _, inner in scopes.values()))
    assert any("/closest_hit/" in p for p in roots)
    assert any("/any_hit/" in p for p in fused)
    # fusions list the ops fused into them
    assert any(len(inner) > 1 for _, inner in scopes.values())
