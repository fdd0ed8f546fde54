"""Veach-style MLT: structured path mutations over the replayable sample
space.

Parity target: ``/root/reference/src/integrators/mlt/mlt.cpp`` with its
mutator set ``src/libbidir/mut_lens.h``, ``mut_caustic.h``, ``mut_mchain.h``,
``mut_manifold.cpp`` — pointer-walking edits of an explicit vertex chain,
each preserving part of the path while regenerating the rest.

Wavefront reframe: the stateless counter RNG makes every path a
*deterministic replay* of its primary-sample table (1 camera block + 3
blocks per bounce), so "preserve part of the path" = "hold those blocks
fixed".  Each reference mutator maps onto a block-structured perturbation of
the table:

- **lens perturbation** (mut_lens.h): exponential screen-space step of the
  image block only.  All BSDF decision blocks are held, so specular /
  glossy chains re-trace through the *same* reflect/refract branches and
  preserved half-vectors — the specular-chain consistency that
  ``mut_manifold.cpp`` restores with Newton iteration falls out of replay
  for free (the batched Newton walk itself lives in
  :mod:`mitsuba_im_tpu.bidir.manifold` and is exercised independently).
- **caustic perturbation** (mut_caustic.h): perturb only the *last*
  bounce's blocks — the tail of the path wiggles across the light while
  the prefix (e.g. the refracting chain into a glass object) is pinned.
- **multi-chain perturbation** (mut_mchain.h): pick a cut bounce k per
  chain, jointly perturb the image block (lens step) and all blocks from
  k on with Kelemen small steps — prefix pinned, suffix regenerated in a
  correlated way.
- **bidirectional mutation** (mut_bidir.h, the ergodicity fallback): a
  fresh independent table = the large step.

Every proposal is symmetric in primary-sample space (additive wrap-around
kernels), so plain Kelemen acceptance ``a = min(1, I'/I)`` is exact — the
transition-density bookkeeping the reference's mutators carry
(``Mutator::Q``) cancels by construction.  The mutation *mixture* is chosen
per chain per step; an ensemble of thousands of chains runs in lockstep,
each step being one fused wavefront re-trace.

**Caustic capability (round 4)**: with ``bidirectional=true`` the chain is
evaluated through the unified splat sampler (:mod:`..bidir.pathsampler`,
the reference's ``PathSampler::sampleSplats``, ``pathsampler.h:121``), so
the s>=2, t=1 light-tracing strategies — which carry caustics seen on
diffuse receivers — are inside the strategy space and exploitable by the
(still symmetric, hence Q-free) PSS mutation mixture; the caustic
mutation then perturbs the *light* subpath blocks with the eye path
pinned, the PSS counterpart of ``mut_caustic.cpp``'s tail perturbation.
Measured on the glass-sphere caustic scene (tests/test_mcmc.py):
caustic-region relative error 0.135 (bidir MLT) vs 0.366 (path tracer)
vs 0.64 (eye-replay MLT) at equal mutation budget.

**Manifold perturbation (round 5)**: the reference's ``mut_manifold.cpp``
is now a production mutation (``p_manifold`` in the mixture, bidirectional
space): :func:`_manifold_tables` perturbs the endpoint after a specular
chain, Newton-re-solves the chain (:mod:`..bidir.manifold`), and writes
the move back as a primary-sample table edit through the exact
cosine-hemisphere inverse warp, with the asymmetric proposal's
D(x')/D(x) (manifold-map determinants, the quantity whose
detailed-balance reciprocity tests/test_manifold.py verifies) carried
into the acceptance.  Non-matching lanes propose the identity, so the
component kernel stays well-defined.  Measured honestly: on the
glass-sphere caustic scene the mutation does NOT beat the bidirectional
splat space at equal budget (caustic err 0.099 vs 0.084 at
p_manifold=0.15 — light tracing already covers camera-visible
receivers), so the default weight is small (0.05); its win class is
doubly-specular-separated (SDS) transport where both endpoint
connections are blocked, which needs the deeper chain-start patterns
(a = eye_vs[i0], i0 > 0) listed as the remaining extension.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..core.types import pytree_dataclass, static_field, Float, Int
from ..core import rng as mrng
from ..scene.scene import Scene
from .pssmlt import (_draw_table, _eval, _mutate_small, _n_blocks,
                     _splat_px, PSSMLTConfig, pssmlt_init)

U32 = jnp.uint32


@pytree_dataclass
class MLTConfig:
    max_depth: int = static_field(default=8)
    rr_depth: int = static_field(default=5)
    n_chains: int = static_field(default=8192)
    burn_in: int = static_field(default=64)
    p_large: float = static_field(default=0.1)   # bidirectional mutation
    p_lens: float = static_field(default=0.35)
    p_caustic: float = static_field(default=0.2)
    p_mchain: float = static_field(default=0.15)
    # manifold perturbation (mut_manifold.cpp analog, bidirectional space
    # only): Newton-re-solved specular-chain moves expressed as
    # primary-sample table edits; see _manifold_tables
    p_manifold: float = static_field(default=0.05)
    # tangent step as a fraction of the scene bounding radius; measured
    # Newton+backtracking convergence radius on the caustic scene's glass
    # chains is ~2e-4 x bsphere (larger steps fail to re-converge and
    # propose identity), so the default stays inside it — the reference's
    # manifold perturbation is likewise a small-step local move
    manifold_sigma: float = static_field(default=2e-4)
    # remaining probability: plain Kelemen small step
    s1: float = static_field(default=1.0 / 1024.0)
    s2: float = static_field(default=1.0 / 64.0)
    # lens step radii in normalized screen units (mut_lens.h r1/r2 analog)
    lens_r1: float = static_field(default=0.0002)
    lens_r2: float = static_field(default=0.05)
    # separateDirect (mlt.cpp): plain sampling renders depth<=2, MCMC
    # only the indirect residual
    separate_direct: bool = static_field(default=True)
    direct_samples: int = static_field(default=16)
    # evaluate states through the unified bidirectional splat sampler
    # (bidir/pathsampler.py = pathsampler.h:121 sampleSplats): light-tracing
    # strategies enter the chain's strategy space, so caustics seen through
    # glass are exploitable by perturbation instead of being separated from
    # the eye-replay space by a zero-contribution moat.  ON by default for
    # reference parity (MLT always runs over PathSampler).
    bidirectional: bool = static_field(default=True)
    # scene has participating media (threads the extra per-step walk
    # block through the bidirectional table layout)
    media_blocks: bool = static_field(default=False)


def _pss_cfg(cfg: MLTConfig) -> PSSMLTConfig:
    return PSSMLTConfig(max_depth=cfg.max_depth, rr_depth=cfg.rr_depth,
                        p_large=cfg.p_large, n_chains=cfg.n_chains,
                        burn_in=cfg.burn_in, s1=cfg.s1, s2=cfg.s2,
                        separate_direct=cfg.separate_direct,
                        bidirectional=cfg.bidirectional,
                        media_blocks=cfg.media_blocks)


def _lens_step(u_img, r, phi):
    """Exponential screen step: u_img (N, 2) in [0,1)^2, wrap-around."""
    off = jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi)], axis=-1)
    up = u_img + off
    return up - jnp.floor(up)


def _manifold_tables(scene, table, cfg, u_gauss):
    """Manifold perturbation as a primary-sample-space table edit
    (``/root/reference/src/libbidir/mut_manifold.cpp`` analog).

    For eye paths of shape  a(diffuse) -> S..S(delta chain, K in {1,2})
    -> b(non-delta):  perturb ``b`` on its tangent plane (Gaussian),
    Newton-re-solve the specular chain (:func:`..bidir.manifold
    .manifold_walk`), and express the move as an edit of ``a``'s
    cosine-hemisphere sample via the exact inverse warp
    (u1 = x^2+y^2, u2 = atan2(y,x)/2pi).  The proposal is asymmetric:
    the acceptance carries D(x')/D(x) with
    D = (cos_a/pi) * (cos_c0/d^2) * |det J_manifold|, the density of the
    table coordinates as a function of the perturbed endpoint — J from
    :func:`..bidir.manifold.manifold_map_jacobian` (the same determinant
    whose reciprocity the detailed-balance chi2 in tests/test_manifold.py
    verifies).  Lanes without a matching chain propose the identity
    (a no-op accept), so the component kernel stays well-defined;
    non-converged walks and warps leaving the hemisphere are identity
    too.  Only the bidirectional table layout is supported (the eye walk
    IS bdpt's random_walk there).

    Returns (prop_table, corr (N,) multiplicative acceptance factor,
    moved (N,)).
    """
    from ..bidir import manifold as mf
    from ..bsdf import common as bc
    from .bdpt import random_walk, camera_pdf_dir, _dir
    from ..sensor.table import sample_ray
    from ..core import math as m

    n = table.shape[0]
    chain = jnp.arange(n, dtype=U32)
    s = mrng.make_sampler(chain, jnp.uint32(0), jnp.uint32(0))
    s = s.replace(table=table)
    s, blk0 = mrng.next_block4(s)
    uv = blk0[..., 0:2]
    o, d, _w = sample_ray(scene.sensor, uv, blk0[..., 2:4])
    has_media = bool(scene.media.any)
    mid0 = (jnp.full((n,), scene.camera_medium, jnp.int32)
            if has_media else None)
    eye_vs, s, _esc, _ = random_walk(
        scene, s, o, d, jnp.ones((n, 3), Float), camera_pdf_dir(scene, d),
        cfg.max_depth, o, d, medium0=mid0)
    per_step = 2 if cfg.media_blocks else 1

    # Box-Muller from the two mutation-selection uniforms
    r_g = jnp.sqrt(-2.0 * jnp.log(jnp.maximum(u_gauss[:, 0], 1e-12)))
    g1 = r_g * jnp.cos(2.0 * jnp.pi * u_gauss[:, 1])
    g2 = r_g * jnp.sin(2.0 * jnp.pi * u_gauss[:, 1])
    sigma = cfg.manifold_sigma * scene.emitters.bsphere_radius

    prop = table
    corr = jnp.ones((n,), Float)
    moved = jnp.zeros((n,), bool)

    # chain-start offsets: i0=0 covers receivers seen directly by the
    # camera; i0=2 covers SDS transport (receiver seen THROUGH a leading
    # two-vertex specular chain, e.g. a caustic behind glass) — there both
    # endpoint connections are specular-blocked and this mutation is the
    # only local move that tracks the chain (mut_manifold.cpp's motivating
    # class).  Measured on the glass-sphere caustic scene: SDS candidates
    # are rare (~1e-4 of random states) and their 4-constraint chains sit
    # outside the damped walk's convergence basin when the endpoint is
    # the small light sphere, so these lanes currently no-op (safe);
    # widening the basin (better preconditioning) is the open item.
    for i0, K in ((0, 1), (0, 2), (2, 1), (2, 2)):
        if i0 + K + 1 >= len(eye_vs):
            continue
        blk_a = 1 + per_step * i0 + (per_step - 1)
        a = eye_vs[i0]
        ch = eye_vs[i0 + 1:i0 + 1 + K]
        b = eye_vs[i0 + K + 1]
        pat = a["valid"] & ~a["delta"] & b["valid"] & ~b["delta"]
        for j in range(i0):  # leading specular prefix (SDS patterns)
            pat = pat & eye_vs[j]["valid"] & eye_vs[j]["delta"]
        for c in ch:
            pat = pat & c["valid"] & c["delta"]
        # the inverse warp is exact for cosine-hemisphere lobes only
        pat = pat & (a["bp"].type == bc.DIFFUSE)

        # per-vertex relative IOR from the replayed geometry: reflection
        # keeps eta=1; refraction uses eta_s oriented by the crossing
        pos = jnp.stack([c["p"] for c in ch], axis=1)        # (N, K, 3)
        nrm = jnp.stack([c["ns"] for c in ch], axis=1)
        etas = []
        for i, c in enumerate(ch):
            nxt = b["p"] if i == K - 1 else ch[i + 1]["p"]
            wo_c = _dir(c["p"], nxt)
            wi_c = c["wi_world"] if "wi_world" in c else -_dir(
                (a["p"] if i == 0 else ch[i - 1]["p"]), c["p"])
            ci = m.dot(wi_c, c["ns"])
            co = m.dot(wo_c, c["ns"])
            refr = ci * co < 0
            entering = ci > 0
            es = jnp.maximum(c["bp"].eta_s, 1e-3)
            etas.append(jnp.where(refr,
                                  jnp.where(entering, es, 1.0 / es), 1.0))
        eta = jnp.stack(etas, axis=1)                        # (N, K)

        tb, bb = mf._tangent_frame(b["ns"])
        b_new = b["p"] + sigma * (g1[:, None] * tb + g2[:, None] * bb)
        p2, n2, s2, conv = mf.manifold_walk(scene, a["p"], pos, b_new, eta)
        # chain must stay on the same surfaces (a jump to another shape
        # breaks the reverse-proposal structure)
        same = conv
        for i, c in enumerate(ch):
            same = same & (s2[:, i] == c["shape"])

        wo_new = _dir(a["p"], p2[:, 0])
        fr = (a["ss"], a["ts"], a["ns"])
        wol = m.Frame.to_local(fr, wo_new)
        ok = pat & same & (wol[..., 2] > 1e-4)
        u1 = jnp.clip(wol[..., 0] ** 2 + wol[..., 1] ** 2, 0.0, 0.999999)
        ph = jnp.arctan2(wol[..., 1], wol[..., 0]) / (2.0 * jnp.pi)
        u2 = ph - jnp.floor(ph)

        # D at both states (vmapped 2x2 manifold-map determinants)
        det_b = jax.vmap(mf.manifold_map_det,
                         in_axes=(0, 0, 0, 0, 0, (0, 0)))
        d_old = det_b(a["p"], pos, b["p"], nrm, eta, (tb, bb))
        d_new = det_b(a["p"], p2, b_new, n2, eta, (tb, bb))
        wo_old = _dir(a["p"], ch[0]["p"])
        cos_a_old = jnp.abs(m.dot(wo_old, a["ns"]))
        cos_a_new = jnp.abs(wol[..., 2])
        d2_old = jnp.sum((ch[0]["p"] - a["p"]) ** 2, -1)
        d2_new = jnp.sum((p2[:, 0] - a["p"]) ** 2, -1)
        cos_c_old = jnp.abs(m.dot(wo_old, ch[0]["ns"]))
        cos_c_new = jnp.abs(m.dot(wo_new, n2[:, 0]))
        D_old = cos_a_old * cos_c_old / jnp.maximum(d2_old, 1e-12) * d_old
        D_new = cos_a_new * cos_c_new / jnp.maximum(d2_new, 1e-12) * d_new
        ratio = jnp.where((D_old > 1e-20) & (D_new > 1e-20),
                          D_new / jnp.maximum(D_old, 1e-20), 0.0)
        ok = ok & (ratio > 0) & jnp.isfinite(ratio)

        edit = table.at[:, blk_a, 1].set(jnp.where(ok, u1,
                                                   table[:, blk_a, 1]))
        edit = edit.at[:, blk_a, 2].set(jnp.where(ok, u2,
                                                  edit[:, blk_a, 2]))
        prop = jnp.where(ok[:, None, None], edit, prop)
        corr = jnp.where(ok, ratio, corr)
        moved = moved | ok
    return prop, corr, moved


def mlt_step_tables(table, u_aux, cfg: MLTConfig, chain, t, seed,
                    scene=None):
    """Build the proposal table for every chain (mixture of mutators).

    u_aux: (N, 4) mutation-selection uniforms.  Returns
    (prop, is_large, corr) with ``corr`` the multiplicative acceptance
    factor of asymmetric components (1 for the symmetric PSS mutators,
    D(x')/D(x) for manifold perturbations).
    """
    n_blocks = _n_blocks(_pss_cfg(cfg))
    n_iters = max(cfg.max_depth - 1, 0)
    N = table.shape[0]

    fresh = _draw_table(chain, t, seed, n_blocks, stream=1)
    xi = _draw_table(chain, t, seed, n_blocks, stream=2)
    xi_sign = _draw_table(chain, t, seed, n_blocks, stream=3)
    small = _mutate_small(table, xi, xi_sign, cfg.s1, cfg.s2)

    u = u_aux[:, 0]
    p0 = cfg.p_large
    p1 = p0 + cfg.p_lens
    p2 = p1 + cfg.p_caustic
    p3 = p2 + cfg.p_mchain
    use_manifold = (scene is not None and cfg.bidirectional
                    and cfg.p_manifold > 0)
    p4 = p3 + (cfg.p_manifold if use_manifold else 0.0)
    is_large = u < p0
    is_lens = (u >= p0) & (u < p1)
    is_caustic = (u >= p1) & (u < p2)
    is_mchain = (u >= p2) & (u < p3)
    is_manifold = (u >= p3) & (u < p4)

    # exponential radius r2*exp(-log(r2/r1)*xi) (mut_lens.h sampling)
    r = cfg.lens_r2 * jnp.exp(-jnp.log(cfg.lens_r2 / cfg.lens_r1)
                              * u_aux[:, 1])
    phi = 2.0 * jnp.pi * u_aux[:, 2]
    img_new = _lens_step(table[:, 0, 0:2], r, phi)

    # -- lens: move the image block, pin everything else -------------------
    lens_tab = table.at[:, 0, 0:2].set(img_new)

    # block layout differs per evaluation backend:
    #   unidirectional replay: [cam | 3 blocks per eye bounce]
    #   bidirectional splats:  [cam | D eye-walk | 2 light-origin |
    #                           D-1 light-walk]
    if cfg.bidirectional:
        # -- caustic (bidir): pin the whole eye path, perturb the light
        # subpath — the light-side wiggle of a caustic path, the PSS
        # counterpart of mut_caustic.cpp's tail perturbation
        per_step = 2 if cfg.media_blocks else 1
        b0_caustic = 1 + per_step * cfg.max_depth
        blocks_per_bounce = per_step
    else:
        # -- caustic: perturb only the last bounce's three blocks ----------
        b0_caustic = 1 + 3 * (n_iters - 1)
        blocks_per_bounce = 3

    caustic_tab = table
    if n_iters > 0:
        caustic_tab = jnp.concatenate(
            [table[:, :b0_caustic], small[:, b0_caustic:]], axis=1)

    # -- multi-chain: lens step + small-step suffix from a random bounce ---
    if n_iters > 0:
        kcut = jnp.minimum((u_aux[:, 3] * n_iters).astype(Int), n_iters - 1)
        bcut = 1 + blocks_per_bounce * kcut  # first block of the cut bounce
        bidx = jax.lax.broadcasted_iota(Int, (N, n_blocks), 1)
        suffix = bidx >= bcut[:, None]
        mchain_tab = jnp.where(suffix[..., None], small, table)
        mchain_tab = mchain_tab.at[:, 0, 0:2].set(img_new)
    else:
        mchain_tab = lens_tab

    corr = jnp.ones((N,), Float)
    prop = small
    if use_manifold:
        man_tab, man_corr, _moved = _manifold_tables(
            scene, table, cfg, u_aux[:, 1:3])
        prop = jnp.where(is_manifold[:, None, None], man_tab, prop)
        corr = jnp.where(is_manifold, man_corr, corr)
    prop = jnp.where(is_mchain[:, None, None], mchain_tab, prop)
    prop = jnp.where(is_caustic[:, None, None], caustic_tab, prop)
    prop = jnp.where(is_lens[:, None, None], lens_tab, prop)
    prop = jnp.where(is_large[:, None, None], fresh, prop)
    return prop, is_large, corr


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "width", "height", "n_steps", "accumulate"),
    donate_argnames=("img",),
)
def mlt_run(scene: Scene, img: jax.Array, state, seed, step0, *, cfg,
            width, height, n_steps, accumulate):
    """Advance the ensemble by ``n_steps`` Metropolis steps (one jit call)."""
    from ..core.spectrum import luminance  # noqa: F401 (parity w/ pssmlt)

    n = cfg.n_chains
    chain = jnp.arange(n, dtype=U32)
    pss = _pss_cfg(cfg)

    def step(i, carry):
        img, table, pos, color, I, b_sum, b_cnt = carry
        t = step0 + i.astype(U32)
        u_misc = _draw_table(chain, t, seed, 2, stream=4)[:, :, :]
        u_aux = u_misc[:, 0, :]
        prop, is_large, corr = mlt_step_tables(table, u_aux, cfg, chain,
                                               t, seed, scene=scene)

        pos_p, color_p, I_p = _eval(scene, prop, pss, width, height)

        b_sum = b_sum + jnp.sum(jnp.where(is_large, I_p, 0.0))
        b_cnt = b_cnt + jnp.sum(is_large.astype(Float))

        a = jnp.where(I > 0,
                      jnp.minimum(1.0, corr * I_p / jnp.maximum(I, 1e-30)),
                      jnp.where(I_p > 0, 1.0, 0.0))

        if accumulate:
            w_cur = jnp.where(I > 0, (1.0 - a) / jnp.maximum(I, 1e-30), 0.0)
            w_prop = jnp.where(I_p > 0, a / jnp.maximum(I_p, 1e-30), 0.0)
            img = _splat_px(img, pos, color, w_cur)
            img = _splat_px(img, pos_p, color_p, w_prop)

        accept = u_misc[:, 1, 0] < a
        table = jnp.where(accept[:, None, None], prop, table)
        pos = jnp.where(accept[:, None, None], pos_p, pos)
        color = jnp.where(accept[:, None, None], color_p, color)
        I = jnp.where(accept, I_p, I)
        return img, table, pos, color, I, b_sum, b_cnt

    carry = (img,) + state
    carry = jax.lax.fori_loop(0, n_steps, step, carry)
    return carry[0], carry[1:]


def render_mlt(scene: Scene, settings, spp: int | None = None,
               progress_cb=None) -> np.ndarray:
    """Full MLT render -> (H, W, 3) numpy image (spp = mutations/pixel)."""
    ip = settings.integrator_props
    md = ip.get("max_depth", -1)
    cfg = MLTConfig(
        max_depth=md if md > 0 else 8,
        rr_depth=ip.get("rr_depth", 5),
        n_chains=ip.get("n_chains", 8192),
        burn_in=ip.get("burn_in", 64),
        p_large=ip.get("p_large", 0.1),
        p_lens=ip.get("p_lens", 0.35),
        p_caustic=ip.get("p_caustic", 0.2),
        p_mchain=ip.get("p_mchain", 0.15),
        p_manifold=ip.get("p_manifold", 0.05),
        manifold_sigma=ip.get("manifold_sigma", 2e-4),
        # the bidirectional splat space already carries depth<=2 strategies
        # with full MIS, so the separate-direct split (an eye-replay
        # variance fix) would double-count them; it is forced off
        separate_direct=(ip.get("separate_direct", True)
                         and not ip.get("bidirectional", True)),
        bidirectional=ip.get("bidirectional", True),
        media_blocks=bool(scene.media.any),
        direct_samples=ip.get("direct_samples", 16),
    )
    W, H = settings.width, settings.height
    spp = spp if spp is not None else settings.spp
    total_mut = W * H * spp
    n_steps = max(total_mut // cfg.n_chains, 1)
    seed = jnp.uint32(settings.seed)

    state = pssmlt_init(scene, seed, cfg=_pss_cfg(cfg), width=W, height=H)
    img = jnp.zeros((H, W, 3), Float)

    burn = min(cfg.burn_in, n_steps // 4) if n_steps > 8 else 0
    if burn:
        img, state = mlt_run(scene, img, state, seed, jnp.uint32(1),
                             cfg=cfg, width=W, height=H, n_steps=burn,
                             accumulate=False)

    chunk = max(min(n_steps - burn, 64), 1)
    done = 0
    remaining = n_steps - burn
    while done < remaining:
        k = min(chunk, remaining - done)
        img, state = mlt_run(
            scene, img, state, seed, jnp.uint32(1 + burn + done),
            cfg=cfg, width=W, height=H, n_steps=k, accumulate=True,
        )
        done += k
        if progress_cb is not None:
            progress_cb(done, remaining, img)

    b_sum, b_cnt = state[4], state[5]
    b = float(b_sum) / max(float(b_cnt), 1.0)
    n_acc = remaining * cfg.n_chains
    scale = b * (W * H) / max(n_acc, 1)
    out = np.asarray(img) * scale

    if cfg.separate_direct and cfg.direct_samples > 0:
        # depth<=2 component with ordinary sampling (mlt.cpp directSamples)
        from ..render.job import render_film
        from ..film.film import develop
        from ..scene.build import RenderSettings

        dset = RenderSettings(
            width=W, height=H, spp=cfg.direct_samples, seed=settings.seed,
            integrator="path",
            integrator_props={"max_depth": 2, "rr_depth": cfg.rr_depth},
            rfilter=settings.rfilter, rfilter_radius=settings.rfilter_radius,
        )
        film = render_film(scene, dset, spp=cfg.direct_samples)
        out = out + np.asarray(develop(film))
    return out
