"""Energy-redistribution path tracing (Cline et al. 2005).

Parity target: ``/root/reference/src/integrators/erpt/`` — ordinary path
tracing generates seed paths; each seed's energy is redistributed along an
equal-deposition Markov chain of local perturbations, preserving
unbiasedness (the seeds are exactly distributed, so chains only reshuffle
energy within luminance contours).

Wavefront shape: one seed per lane (a full W*H wavefront per pass), then a
``lax.fori_loop`` of lockstep small-step mutations in *primary sample space*
(the reference's lens/caustic path-space perturbations don't vectorize over
lanes; the primary-space perturbation explores the same local
neighborhoods).  With ``bidirectional=true`` seeds and chain states are
evaluated through the unified splat sampler
(:mod:`..bidir.pathsampler` = the reference ``PathSampler::sampleSplats``,
``pathsampler.h:121``, which ``erpt_proc.cpp:529`` runs chains over), so
every BDPT strategy — including the t=1 light-tracing splats that carry
caustics — is inside the redistribution chain's strategy space.
Every step deposits

    (1-a) * e_d * C_cur/I_cur   at the current state's pixel
  +    a  * e_d * C_prop/I_prop at the proposed state's pixel

with per-lane deposition energy e_d = I_seed / M, so each chain deposits
exactly its seed's luminance — the energy-conservation property that makes
ERPT unbiased without any global normalization constant.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..core.types import Float
from ..core import rng as mrng
from .pssmlt import (PSSMLTConfig, _draw_table, _eval, _mutate_small,
                     _n_blocks, _splat_px)
from ..scene.scene import Scene

U32 = jnp.uint32


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "width", "height", "chain_length"),
    donate_argnames=("img",),
)
def erpt_pass(scene: Scene, img: jax.Array, pass_idx, seed, *, cfg, width,
              height, chain_length):
    """One seed-per-lane pass + M-step redistribution chains."""
    n_blocks = _n_blocks(cfg)
    n = cfg.n_chains
    chain = jnp.arange(n, dtype=U32)

    # seeds: ordinary path-traced samples (exactly distributed)
    tab0 = _draw_table(chain, pass_idx, seed, n_blocks, stream=0)
    pos0, color0, I0 = _eval(scene, tab0, cfg, width, height)
    e_d = I0 / float(chain_length)  # per-step deposition energy

    def step(i, carry):
        img, table, pos, color, I = carry
        t = pass_idx * U32(0x10001) + i.astype(U32)
        xi = _draw_table(chain, t, seed, n_blocks, stream=2)
        xi_sign = _draw_table(chain, t, seed, n_blocks, stream=3)
        u_misc = _draw_table(chain, t, seed, 1, stream=4)[:, 0, :]
        prop = _mutate_small(table, xi, xi_sign, cfg.s1, cfg.s2)
        pos_p, color_p, I_p = _eval(scene, prop, cfg, width, height)

        a = jnp.where(I > 0, jnp.minimum(1.0, I_p / jnp.maximum(I, 1e-30)),
                      jnp.where(I_p > 0, 1.0, 0.0))
        w_cur = jnp.where(I > 0, (1.0 - a) * e_d / jnp.maximum(I, 1e-30), 0.0)
        w_prop = jnp.where(I_p > 0, a * e_d / jnp.maximum(I_p, 1e-30), 0.0)
        img = _splat_px(img, pos, color, w_cur)
        img = _splat_px(img, pos_p, color_p, w_prop)

        accept = u_misc[:, 1] < a
        table = jnp.where(accept[:, None, None], prop, table)
        # pos/color are (N, S, 2)/(N, S, 3): the accept mask must broadcast
        # over BOTH trailing dims ((N, 1) against (N, S, 2) right-aligns to
        # an (N, N, 2) outer product — a silent chain scramble/OOM)
        pos = jnp.where(accept[:, None, None], pos_p, pos)
        color = jnp.where(accept[:, None, None], color_p, color)
        I = jnp.where(accept, I_p, I)
        return img, table, pos, color, I

    carry = (img, tab0, pos0, color0, I0)
    carry = jax.lax.fori_loop(0, chain_length, step, carry)
    return carry[0]


def render_erpt(scene: Scene, settings, spp: int | None = None) -> np.ndarray:
    """ERPT render; ``spp`` = seed paths per pixel."""
    ip = settings.integrator_props
    md = ip.get("max_depth", -1)
    W, H = settings.width, settings.height
    spp = spp if spp is not None else settings.spp
    chain_length = int(ip.get("chain_length", 100))
    cfg = PSSMLTConfig(
        max_depth=md if md > 0 else 8,
        rr_depth=ip.get("rr_depth", 5),
        n_chains=W * H,
        bidirectional=ip.get("bidirectional", False),
        media_blocks=bool(scene.media.any),
    )
    seed = jnp.uint32(settings.seed)
    img = jnp.zeros((H, W, 3), Float)
    for p in range(spp):
        img = erpt_pass(scene, img, jnp.uint32(p + 1), seed, cfg=cfg,
                        width=W, height=H, chain_length=chain_length)
    # each pass deposits total energy ~ sum of seed luminances; PT
    # normalization: mean over seeds, image-plane factor npix
    return np.asarray(img) * (W * H / (spp * W * H))
