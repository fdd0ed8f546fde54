"""Plugin registry: the wavefront analog of the reference plugin manager.

The reference discovers ``.so`` plugins per category by scanning binaries for
marker symbols and instantiates them from ``Properties``
(``/root/reference/src/libcore/plugin.cpp:256-295``).  Here, a plugin is a
Python factory registered under ``(category, name)`` that consumes a
``Properties`` bag and returns a host-side description object; categories and
names are introspectable (configurator analog), and each factory may expose a
``params`` schema describing its parameters (name, type, default).
"""
from __future__ import annotations

from typing import Any, Callable

from .properties import Properties

_REGISTRY: dict[str, dict[str, Callable]] = {}
_SCHEMAS: dict[tuple[str, str], list[tuple[str, str, Any]]] = {}

CATEGORIES = (
    "integrator",
    "bsdf",
    "shape",
    "emitter",
    "sensor",
    "sampler",
    "film",
    "rfilter",
    "texture",
    "medium",
    "phase",
    "volume",
    "subsurface",
    "utility",
)


def register(category: str, name: str, schema=None):
    """Decorator: register a plugin factory."""

    def deco(fn):
        _REGISTRY.setdefault(category, {})[name] = fn
        if schema is not None:
            _SCHEMAS[(category, name)] = schema
        return fn

    return deco


def warn_substitution(category: str, requested: str, actual: str, why: str = ""):
    """Loudly record that plugin ``requested`` was substituted by ``actual``.

    The reference loads the exact named plugin or fails; any remaining
    capability gap here must be visible: a WARN log line at scene build and
    a tracked counter in the statistics report (never a silent alias).
    """
    from .logger import Log, EWarn
    from . import statistics

    Log(EWarn,
        f"plugin substitution: {category} '{requested}' is rendered as "
        f"'{actual}'" + (f" ({why})" if why else ""),
        component="registry")
    statistics.record("Plugin substitutions", f"{requested} -> {actual}", 1)


def create(category: str, props: Properties, ctx=None):
    """Instantiate plugin ``props.plugin_name`` of the given category.

    ``ctx`` is the SceneBuilder during scene loading (factories register
    textures/bsdfs/geometry through it)."""
    _ensure_loaded()
    cat = _REGISTRY.get(category, {})
    name = props.plugin_name
    if name not in cat:
        raise ValueError(
            f"Unknown {category} plugin '{name}'. Available: {sorted(cat)}"
        )
    return cat[name](props, ctx)


def available_plugins(category: str) -> list[str]:
    """Discoverable plugin list (plugin.cpp getAvailablePlugins analog)."""
    _ensure_loaded()
    return sorted(_REGISTRY.get(category, {}).keys())


def extract_parameters(category: str, name: str) -> dict[str, Any]:
    """Auto-extract a plugin's parameter names and defaults by instantiating
    it with query recording on (configurator.cpp:139-160 analog)."""
    _ensure_loaded()
    props = Properties(name).record_queries_and_defaults(True)
    try:
        create(category, props, None)
    except KeyError:
        pass  # required params missing is fine; queries were still recorded
    except Exception:
        pass
    return props.recorded_defaults


_loaded = False


def _ensure_loaded():
    """Import all plugin modules once (they self-register on import)."""
    global _loaded
    if _loaded:
        return
    _loaded = True
    import importlib

    for mod in (
        "mitsuba_im_tpu.bsdf",
        "mitsuba_im_tpu.emitter",
        "mitsuba_im_tpu.sensor",
        "mitsuba_im_tpu.sampler",
        "mitsuba_im_tpu.film",
        "mitsuba_im_tpu.texture",
        "mitsuba_im_tpu.scene.shapes",
        "mitsuba_im_tpu.media",
        "mitsuba_im_tpu.integrators",
        "mitsuba_im_tpu.subsurface",
        "mitsuba_im_tpu.cli.mtsutil",
    ):
        importlib.import_module(mod)
