"""Unified path-space splat sampler: every BDPT strategy from one table.

Parity target: ``/root/reference/include/mitsuba/bidir/pathsampler.h:121``
(``PathSampler::sampleSplats``) — the bridge between libbidir and the MCMC
integrators: given one primary-sample state it generates eye and light
subpaths, evaluates EVERY (s, t) bidirectional strategy with MIS weights,
and returns the list of weighted splats (the t=1 light-tracing strategies
land at their own film positions).  The reference's MLT/ERPT seed and
re-evaluate chains through this, so light-tracing-dominant features
(caustics seen through glass, strong indirect) are inside the MCMC
strategy space.

Wavefront shape: the sampler state is the (N, B, 4) primary-sample table
of a lockstep chain ensemble; one call evaluates all strategies for every
chain as fused wavefronts (reusing :func:`integrators.bdpt.bdpt_sample`'s
static-depth SoA machinery).  The scalar Metropolis target is the summed
luminance of all splats, exactly the reference's ``SplatList::luminance``
(``pathsampler.h:173``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.types import Float
from ..core import rng as mrng
from ..core.spectrum import luminance
from ..sensor.table import sample_ray
from ..scene.scene import Scene

U32 = jnp.uint32


def n_blocks_bidir(max_depth: int, has_media: bool = False) -> int:
    """Blocks of 4 dims consumed per sampleSplats evaluation.

    1 camera + max_depth eye-walk + 2 light-origin + (max_depth-1)
    light-walk + (max_depth-1) s=1 NEE blocks (matches the draw order in
    bdpt_sample: eye walk, light origin, light walk, then one block per
    eye vertex for next-event estimation).  Scenes with media draw one
    extra free-flight/phase block per walk step.  All of these must be
    table-backed so MCMC mutations reach every strategy's randoms —
    otherwise the NEE draws fall off the table and freeze for the whole
    chain (biased stationary distribution)."""
    per_step = 2 if has_media else 1
    return (1 + per_step * max_depth + 2
            + per_step * max(max_depth - 1, 0) + max(max_depth - 1, 0))


def n_light_splats(max_depth: int) -> int:
    """Number of t=1 (light-tracing) strategies bdpt_sample emits."""
    # one per light-subpath vertex si in [1, S) with si+1+1-1 <= max_depth
    return max(max_depth - 1, 0)


def sample_splats(scene: Scene, table: jax.Array, max_depth: int,
                  width: int, height: int):
    """Evaluate all BDPT strategies for a batch of primary-sample tables.

    table: (N, B, 4) with B >= n_blocks_bidir(max_depth, scene.media.any).

    Returns (pos (N, 2) eye-pixel coords, li (N, 3) same-pixel radiance,
    splat_pos (K, N, 2) film coords of light-tracing splats,
    splat_val (K, N, 3), I (N,) total splat luminance — the Metropolis
    target, SplatList::luminance).
    """
    from ..integrators.bdpt import bdpt_sample

    n = table.shape[0]
    chain = jnp.arange(n, dtype=U32)
    s = mrng.make_sampler(chain, jnp.uint32(0), jnp.uint32(0))
    s = s.replace(table=table)
    s, blk0 = mrng.next_block4(s)
    uv = blk0[..., 0:2]
    o, d, w_sensor = sample_ray(scene.sensor, uv, blk0[..., 2:4])
    li, s_uv, s_val = bdpt_sample(scene, s, o, d, max_depth)
    li = jnp.nan_to_num(li, nan=0.0, posinf=0.0, neginf=0.0) \
        * w_sensor[..., None]
    s_val = jnp.nan_to_num(s_val, nan=0.0, posinf=0.0, neginf=0.0)
    wh = jnp.asarray([width, height], Float)
    pos = uv * wh
    splat_pos = s_uv * wh
    I = luminance(li)
    if s_val.shape[0]:
        I = I + luminance(s_val).sum(axis=0)
    return pos, li, splat_pos, s_val, I
