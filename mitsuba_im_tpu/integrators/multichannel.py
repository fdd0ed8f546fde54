"""Multi-channel rendering (reference ``src/integrators/misc/multichannel.cpp``).

The reference runs several sub-integrators per sample and writes each into
its own film channel block.  Wavefront reframe: each child renders as its own
jit-compiled wavefront over the same sample streams (children are
independent estimators, so sequential passes produce the same channels as
the reference's interleaved evaluation), and the results are stacked into
named EXR layers (``<child>.R/G/B``) on develop.  The first child is the
primary RGB image for LDR outputs and previews.
"""
from __future__ import annotations

import numpy as np


def render_multichannel(scene, settings, spp=None):
    """Render every child integrator; returns the primary (first) image and
    stashes the full named-channel stack on ``settings.aux_channels`` for
    the EXR writer."""
    from ..render.job import render
    from ..scene.build import RenderSettings

    children = settings.integrator_props.get("children", [])
    if not children:
        children = [dict(name="path")]

    images = []
    names = []
    used = {}
    for child in children:
        child = dict(child)
        cname = child.pop("name", "path")
        sub = RenderSettings(
            width=settings.width, height=settings.height,
            spp=settings.spp, sampler=settings.sampler, seed=settings.seed,
            integrator=cname, integrator_props=child,
            rfilter=settings.rfilter, rfilter_radius=settings.rfilter_radius,
        )
        img = np.asarray(render(scene, sub, spp=spp))
        # unique layer name per child (path, path2, ...)
        used[cname] = used.get(cname, 0) + 1
        layer = cname if used[cname] == 1 else f"{cname}{used[cname]}"
        images.append(img)
        names.append(layer)

    # named channels: first child is the primary RGB; extra children become
    # "<layer>.R/G/B" EXR layers
    channel_names = ["R", "G", "B"]
    for layer in names[1:]:
        channel_names += [f"{layer}.R", f"{layer}.G", f"{layer}.B"]
    stack = np.concatenate(images, axis=-1)
    settings.aux_channels = (channel_names, stack)
    return images[0]
