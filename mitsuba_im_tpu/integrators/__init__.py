"""Integrator plugin factories (``/root/reference/src/integrators/``).

Factories record the integrator name + its parameters into the render
settings; the render layer dispatches to the matching wavefront kernel
(path/volpath/direct/ao/field/motion/ptracer/bdpt/pssmlt/erpt/photon
mappers/vpl/adaptive/multichannel all have device implementations; the
path-space ``mlt`` rides the primary-sample ensemble engine, and
``irrcache`` currently delegates to its nested integrator).
"""
from __future__ import annotations

import warnings

from ..core.registry import register
from ..core.properties import Properties

IMPLEMENTED = ("path", "volpath", "volpath_simple", "direct", "ao", "field",
               "ptracer", "adaptive", "multichannel", "irrcache", "motion")


def _mc_props(props: Properties) -> dict:
    return dict(
        max_depth=props.get_int("maxDepth", -1),
        rr_depth=props.get_int("rrDepth", 5),
        strict_normals=props.get_bool("strictNormals", False),
        hide_emitters=props.get_bool("hideEmitters", False),
    )


def _set(ctx, name, ip):
    if ctx is not None:
        ctx.settings.integrator = name
        ctx.settings.integrator_props = ip
    return dict(name=name, **ip)


@register("integrator", "path")
def _path(props: Properties, ctx=None):
    return _set(ctx, "path", _mc_props(props))


@register("integrator", "volpath")
def _volpath(props: Properties, ctx=None):
    return _set(ctx, "volpath", _mc_props(props))


@register("integrator", "volpath_simple")
def _volpath_simple(props: Properties, ctx=None):
    return _set(ctx, "volpath", _mc_props(props))


@register("integrator", "direct")
def _direct(props: Properties, ctx=None):
    ip = dict(
        emitter_samples=props.get_int("emitterSamples", props.get_int("shadingSamples", 1)),
        bsdf_samples=props.get_int("bsdfSamples", props.get_int("shadingSamples", 1)),
        strict_normals=props.get_bool("strictNormals", False),
        hide_emitters=props.get_bool("hideEmitters", False),
    )
    return _set(ctx, "direct", ip)


@register("integrator", "ao")
def _ao(props: Properties, ctx=None):
    ip = dict(
        shading_samples=props.get_int("shadingSamples", 1),
        ray_length=props.get_float("rayLength", -1.0),
    )
    return _set(ctx, "ao", ip)


@register("integrator", "field")
def _field(props: Properties, ctx=None):
    ip = dict(field=props.get_string("field", "position"))
    return _set(ctx, "field", ip)


@register("integrator", "ptracer")
def _ptracer(props: Properties, ctx=None):
    ip = _mc_props(props)
    ip["granularity"] = props.get_int("granularity", 200000)
    return _set(ctx, "ptracer", ip)


@register("integrator", "adaptive")
def _adaptive(props: Properties, ctx=None):
    ip = dict(
        max_error=props.get_float("maxError", 0.05),
        p_value=props.get_float("pValue", 0.05),
        max_spp=props.get_int("maxSampleFactor", 32),
        nested=props.children.get("integrator", dict(name="path")),
    )
    return _set(ctx, "adaptive", ip)


@register("integrator", "multichannel")
def _multichannel(props: Properties, ctx=None):
    subs = props.children.get("integrator_list", [])
    return _set(ctx, "multichannel", dict(children=subs))


@register("integrator", "irrcache")
def _irrcache(props: Properties, ctx=None):
    res = props.get_int("resolution", 14)  # hemisphere elevational strata
    ip = dict(
        quality=props.get_float("quality", 1.0),
        # record-placement pixel stride (this build: camera-grid placement
        # replaces the reference's on-demand octree insertion)
        resolution=props.get_int("stride", 4),
        irr_samples=min(3 * res * res, 1024),
        nested=props.children.get("integrator", dict(name="path")),
    )
    return _set(ctx, "irrcache", ip)


@register("integrator", "pssmlt")
def _pssmlt(props: Properties, ctx=None, _name="pssmlt"):
    ip = _mc_props(props)
    ip["p_large"] = props.get_float("pLarge", 0.3)
    ip["n_chains"] = props.get_int("chains", 8192)
    ip["burn_in"] = props.get_int("burnIn", 32)
    return _set(ctx, _name, ip)


@register("integrator", "mlt")
def _mlt(props: Properties, ctx=None):
    """Veach-style MLT with structured path mutations (lens / caustic /
    multi-chain / bidirectional) over the replayable sample space —
    integrators/mlt.py docstring maps each reference mutator
    (src/libbidir/mut_*.h) onto its block-structured equivalent."""
    ip = _mc_props(props)
    ip["p_large"] = props.get_float("pLarge", 0.1)
    ip["n_chains"] = props.get_int("chains", 8192)
    ip["burn_in"] = props.get_int("burnIn", 64)
    ip["p_lens"] = props.get_float("pLens", 0.35)
    ip["p_caustic"] = props.get_float("pCaustic", 0.2)
    ip["p_mchain"] = props.get_float("pMultiChain", 0.15)
    return _set(ctx, "mlt", ip)


@register("integrator", "erpt")
def _erpt(props: Properties, ctx=None):
    ip = _mc_props(props)
    ip["chain_length"] = props.get_int("chainLength", 100)
    ip["chains_per_pixel"] = props.get_float("numChains", 1.0)
    return _set(ctx, "erpt", ip)


@register("integrator", "bdpt")
def _bdpt(props: Properties, ctx=None):
    ip = _mc_props(props)
    ip["light_image"] = props.get_bool("lightImage", True)
    return _set(ctx, "bdpt", ip)


def _photon(name):
    # photonmapper maps onto the progressive engine (sppm) with the same
    # photon/gather machinery; volume photons + the beam radiance
    # estimate (bre.cpp) are carried by sppm_pass on media scenes
    @register("integrator", name)
    def make(props: Properties, ctx=None, _n=name):
        ip = _mc_props(props)
        ip["photon_count"] = props.get_int(
            "photonCount", props.get_int("globalPhotons", 250000))
        ip["initial_radius"] = props.get_float("initialRadius", 0.0)
        ip["alpha"] = props.get_float("alpha", 0.7)
        ip["lookup_radius_rel"] = props.get_float("globalLookupRadiusRelative", 0.05)
        ip["iterations"] = props.get_int("maxPasses", -1)
        return _set(ctx, _n if _n != "photonmapper" else "sppm", ip)

    return make


for _n in ("photonmapper", "ppm", "sppm"):
    _photon(_n)


@register("integrator", "vpl")
def _vpl(props: Properties, ctx=None):
    ip = dict(
        max_depth=props.get_int("maxDepth", 5),
        vpl_count=props.get_int("vplSamples", props.get_int("shadowMapResolution", 256)),
        clamping=props.get_float("clamping", 0.1),
    )
    return _set(ctx, "vpl", ip)


@register("integrator", "motion")
def _motion(props: Properties, ctx=None):
    ip = dict(time_delta=props.get_float("timeDelta", 1.0 / 24.0))
    return _set(ctx, "motion", ip)
