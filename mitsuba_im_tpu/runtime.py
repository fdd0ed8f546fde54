"""Process set-up shared by the entry points: where compiled programs are
cached, and the device checks of the measurement scripts."""
from __future__ import annotations

import os
import subprocess

# fixed, inside the checkout (listed in .gitignore): a temporary or
# per-process directory would never be found again by the next process
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def enable_compile_cache() -> str | None:
    """Turn on JAX's persistent compilation cache; returns its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is set here.  Otherwise an accelerator process caches in
    ``CACHE_DIR``; a CPU-only process caches nothing (its compiles are
    short, and XLA:CPU warns on every reload of a cached executable)."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    if jax.default_backend() == "cpu":
        return None
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR


def require_gpu(tool: str):
    """The GPU devices JAX found; exits naming what it found otherwise."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"{tool}: needs a GPU, but JAX found {len(devs)} "
            f"{devs[0].platform} device(s) ({devs[0].device_kind})")
    return devs


def device_info() -> dict:
    """The device as JAX reports it: platform, kind and count."""
    import jax

    devs = jax.devices()
    return dict(platform=devs[0].platform, kind=devs[0].device_kind,
                count=len(devs))


def card_info() -> str:
    """Each card's name and power limit, one line per card, as
    ``nvidia-smi`` reports them (a child process that stays off JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()
