"""Participating media / phase function factories.

Round-1 scope: records are parsed and stored (homogeneous sigma_s/sigma_a,
HG g) so volumetric integrators can consume them; the volumetric path
tracer lands with the extended integrator set (SURVEY.md §7 stage 8).
"""
from __future__ import annotations

import numpy as np

from ..core.registry import register
from ..core.properties import Properties

from .medium import (PH_ISOTROPIC, PH_HG, PH_RAYLEIGH, PH_KKAY,
                     PH_MICROFLAKE, PH_MIX)


@register("phase", "isotropic")
def _isotropic(props: Properties, ctx=None):
    return dict(type=PH_ISOTROPIC, g=0.0)


@register("phase", "hg")
def _hg(props: Properties, ctx=None):
    return dict(type=PH_HG, g=props.get_float("g", 0.8))


@register("phase", "rayleigh")
def _rayleigh(props: Properties, ctx=None):
    return dict(type=PH_RAYLEIGH, g=0.0)


@register("phase", "kkay")
def _kkay(props: Properties, ctx=None):
    """Kajiya-Kay fiber phase (src/phase/kkay.cpp:40-42); normalized per
    incident angle against the fiber axis (orientation volume)."""
    return dict(
        type=PH_KKAY, g=0.0,
        ks=props.get_float("ks", 0.4),
        kd=props.get_float("kd", 0.2),
        exponent=props.get_float("exponent", 4.0),
    )


@register("phase", "microflake")
def _microflake(props: Properties, ctx=None):
    """Specular microflake model with the Gaussian fiber distribution
    (src/phase/microflake.cpp:84): flake normals concentrated on the plane
    perpendicular to the local fiber axis with the given stddev."""
    return dict(type=PH_MICROFLAKE, g=0.0,
                stddev=props.get_float("stddev", 0.3))


@register("phase", "mixturephase")
def _mixturephase(props: Properties, ctx=None):
    """Weighted phase mixture (src/phase/mixturephase.cpp): comma-separated
    ``weights`` + nested phase children (isotropic/hg/rayleigh)."""
    wstr = props.get_string("weights", "")
    weights = [float(w) for w in wstr.replace(";", ",").replace(" ", ",")
               .split(",") if w.strip()]
    children = props.children.get("phase_list") or []
    if not children and "phase" in props.children:
        children = [props.children["phase"]]
    if not weights:
        weights = [1.0 / max(len(children), 1)] * len(children)
    if len(weights) != len(children):
        raise ValueError(
            f"mixturephase: {len(weights)} weights vs {len(children)} phases")
    return dict(type=PH_MIX, g=0.0,
                components=list(zip(weights, children)))


@register("medium", "homogeneous")
def _homogeneous(props: Properties, ctx=None):
    sigma_s = props.get_spectrum("sigmaS", np.full(3, 1.0)) if "sigmaS" in props else None
    sigma_a = props.get_spectrum("sigmaA", np.full(3, 1.0)) if "sigmaA" in props else None
    if sigma_s is None and "sigmaT" in props:
        st = props.get_spectrum("sigmaT")
        albedo = props.get_spectrum("albedo", np.full(3, 0.8))
        sigma_s = st * albedo
        sigma_a = st * (1 - albedo)
    rec = dict(
        kind="homogeneous",
        sigma_s=np.asarray(sigma_s if sigma_s is not None else np.full(3, 1.0)),
        sigma_a=np.asarray(sigma_a if sigma_a is not None else np.full(3, 1.0)),
        scale=props.get_float("scale", 1.0),
        phase=props.children.get("phase", dict(type=PH_ISOTROPIC, g=0.0)),
    )
    if ctx is not None:
        ctx.media_records.append(rec)
        rec["id"] = len(ctx.media_records) - 1
    return rec


@register("medium", "heterogeneous")
def _heterogeneous(props: Properties, ctx=None):
    """Grid-density medium (heterogeneous.cpp): sigma_t = scale*density,
    sigma_s = sigma_t*albedo; named child volumes ``density``/``albedo``/
    ``orientation`` (the fiber-axis grid consumed by the kkay/microflake
    phase functions)."""
    props.get_string("method", "woodcock")
    rec = dict(
        kind="heterogeneous",
        scale=props.get_float("scale", 1.0),
        phase=props.children.get("phase", dict(type=PH_ISOTROPIC, g=0.0)),
        density=props.children.get("density"),
        albedo=props.children.get("albedo"),
        orientation=props.children.get("orientation"),
    )
    vlist = props.children.get("volume_list", [])
    if rec["density"] is None and vlist:
        rec["density"] = vlist[0]
    if rec["albedo"] is None and len(vlist) > 1:
        rec["albedo"] = vlist[1]
    if ctx is not None:
        ctx.media_records.append(rec)
        rec["id"] = len(ctx.media_records) - 1
    return rec


@register("volume", "constvolume")
def _constvolume(props: Properties, ctx=None):
    from .volume import const_grid

    if "value" in props:
        try:
            v = props.get_spectrum("value")
        except Exception:
            v = np.full(3, props.get_float("value"))
    else:
        v = np.ones(3)
    return const_grid(np.asarray(v))


@register("volume", "gridvolume")
def _gridvolume(props: Properties, ctx=None):
    from .volume import read_vol

    path = props.get_string("filename", "")
    if ctx is not None and hasattr(ctx, "resolve_path"):
        path = ctx.resolve_path(path)
    rec = read_vol(path)
    to_world = props.get_transform("toWorld")
    rec["world_to_volume"] = to_world.inv
    if "min" in props and "max" in props:
        rec["bmin"] = np.asarray(props.get_point("min"), np.float64)
        rec["bmax"] = np.asarray(props.get_point("max"), np.float64)
    return rec


@register("volume", "hgridvolume")
def _hgridvolume(props: Properties, ctx=None):
    """Hierarchical grid (hgridvolume.cpp:70-127): the dictionary file lists
    occupied cells whose gridvolume blocks are composited into one dense
    grid in the flat device atlas (sparse-block pointer chasing has no place
    on vector lanes; absent cells stay zero)."""
    from .volume import read_hgrid

    path = props.get_string("filename", "")
    if ctx is not None and hasattr(ctx, "resolve_path"):
        path = ctx.resolve_path(path)
    rec = read_hgrid(path, props.get_string("prefix", ""),
                     props.get_string("postfix", ""))
    to_world = props.get_transform("toWorld")
    rec["world_to_volume"] = to_world.inv
    return rec


@register("volume", "volcache")
def _volcache(props: Properties, ctx=None):
    return props.children.get("volume", dict(kind="const", value=np.ones(3)))
