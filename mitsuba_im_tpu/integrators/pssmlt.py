"""Primary-sample-space Metropolis light transport (Kelemen-style MCMC).

Parity target: ``/root/reference/src/integrators/pssmlt/`` — Kelemen et
al. 2002 MLT over the *primary sample space*: a Markov chain mutates the
vector of uniform random numbers that drives an ordinary path tracer, with
"small step" exponential perturbations and "large step" independent restarts
(``pssmlt_sampler.cpp``).  The fork's responsive variant replaces the
two-stage luminance pre-pass with *online* mean-brightness tracking from the
large steps (``pssmlt_proc.cpp:286-611``); we mirror that design.

Wavefront shape (SURVEY.md §2.7 "independent-chain parallelism"): instead of
one chain per CPU thread, a *lockstep ensemble* of thousands of chains lives
in SoA arrays — every Metropolis step is one batched ``path_li`` evaluation
over all chains (a single fused wavefront), acceptance and mutation are
vectorized `where`s, and both the current and proposed states splat into the
film via scatter-add.  The entire render is ONE ``lax.fori_loop`` under jit;
there is no per-chain control flow anywhere.

The primary sample vector is materialized as the sampler's ``table``
(core/rng.py): ``path_li`` consumes exactly ``1 + 3 * n_iters`` blocks of 4
dimensions, so the table fully determines the path — re-evaluation is
deterministic, which is what Metropolis requires.

Estimator: with b = E_uniform[I(u)] (tracked online from large steps) and
N total mutation-steps, pixel j's mean radiance is

    I_j = (n_pixels * b / N) * sum over steps of [ (1-a) C_cur/I_cur 1_j(cur)
                                                  +    a  C_prop/I_prop 1_j(prop) ]

`mlt` and the reference's path-space mutators: pointer-based path editing
(bidir/lens/caustic/manifold perturbations, ``src/libbidir/mut_*.cpp``) does
not vectorize over lanes — each mutation walks a different-length
vertex chain.  The `mlt` plugin therefore maps onto this same ensemble
engine with a lower large-step probability (pure perturbation-style
exploration), preserving the capability (unbiased MCMC rendering robust to
hard visibility) with a wavefront-idiomatic state representation.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..core.types import pytree_dataclass, static_field, Float, Int
from ..core import rng as mrng
from ..core.spectrum import luminance
from ..sensor.table import sample_ray
from ..scene.scene import Scene
from .path import PathConfig, path_li

U32 = jnp.uint32


@pytree_dataclass
class PSSMLTConfig:
    max_depth: int = static_field(default=8)
    rr_depth: int = static_field(default=5)
    p_large: float = static_field(default=0.3)  # pssmlt.cpp pLarge default
    n_chains: int = static_field(default=8192)
    burn_in: int = static_field(default=32)  # steps discarded per chain
    # Kelemen mutation sizes (pssmlt_sampler.cpp: s1=1/1024, s2=1/64)
    s1: float = static_field(default=1.0 / 1024.0)
    s2: float = static_field(default=1.0 / 64.0)
    # MCMC targets indirect only; direct rendered by plain sampling
    # (mlt.cpp/pssmlt.cpp separateDirect + directSamples)
    separate_direct: bool = static_field(default=False)
    # Kelemen over the FULL bidirectional strategy space: each state is
    # evaluated through the unified splat sampler (bidir/pathsampler.py,
    # the reference's PathSampler::sampleSplats, pathsampler.h:121) so
    # light-tracing strategies — caustics seen through glass, strong
    # indirect — are inside the chain's strategy space.  Matches the
    # reference pssmlt.cpp 'bidirectional' plugin parameter.
    bidirectional: bool = static_field(default=False)
    # scene has participating media: bidirectional walks draw one extra
    # free-flight/phase block per step (set from scene.media.any by the
    # render_* entry points so the primary-sample table covers them)
    media_blocks: bool = static_field(default=False)


def _n_blocks(cfg: PSSMLTConfig) -> int:
    """Blocks of 4 dims consumed per eval: 1 camera + 3 per bounce for the
    unidirectional replay; camera + eye walk + light origin + light walk
    for the bidirectional splat sampler."""
    if cfg.bidirectional:
        from ..bidir.pathsampler import n_blocks_bidir

        return n_blocks_bidir(cfg.max_depth, cfg.media_blocks)
    n_iters = max(cfg.max_depth - 1, 0)
    return 1 + 3 * n_iters


def _path_cfg(cfg: PSSMLTConfig) -> PathConfig:
    return PathConfig(max_depth=cfg.max_depth, rr_depth=cfg.rr_depth,
                      depth_budget=cfg.max_depth,
                      skip_direct=cfg.separate_direct,
                      coherent=False)


def _eval(scene: Scene, table: jax.Array, cfg: PSSMLTConfig, width, height):
    """Deterministic evaluation of a batch of primary-sample tables.

    Returns (pos (N,S,2) film px coords, color (N,S,3), I (N,) luminance)
    with S splats per chain state: S=1 (the eye pixel) for unidirectional
    replay; S=1+K for the bidirectional splat sampler, whose K t=1
    light-tracing strategies land at their own film positions
    (``pathsampler.h:173`` SplatList).
    """
    n = table.shape[0]
    if cfg.bidirectional:
        from ..bidir.pathsampler import sample_splats

        pos, li, s_pos, s_val, I = sample_splats(
            scene, table, cfg.max_depth, width, height)
        pos_all = jnp.concatenate(
            [pos[:, None], s_pos.transpose(1, 0, 2)], axis=1)
        col_all = jnp.concatenate(
            [li[:, None], s_val.transpose(1, 0, 2)], axis=1)
        return pos_all, col_all, I
    chain = jnp.arange(n, dtype=U32)
    s = mrng.make_sampler(chain, jnp.uint32(0), jnp.uint32(0))
    s = s.replace(table=table)
    s, blk0 = mrng.next_block4(s)
    uv = blk0[..., 0:2]
    o, d, w_sensor = sample_ray(scene.sensor, uv, blk0[..., 2:4])
    li, _ = path_li(scene, s, o, d, _path_cfg(cfg))
    li = jnp.nan_to_num(li, nan=0.0, posinf=0.0, neginf=0.0) * w_sensor[..., None]
    pos = uv * jnp.asarray([width, height], Float)
    return pos[:, None], li[:, None], luminance(li)


def _draw_table(chain, step, seed, n_blocks, stream):
    """Fresh (N, B, 4) uniforms from the counter RNG (one hash per block)."""
    s = mrng.make_sampler(chain, step, seed ^ U32((stream * 0x9E3779B1) & 0xFFFFFFFF))
    blocks = []
    for _ in range(n_blocks):
        s, u = mrng.next_block4(s)
        blocks.append(u)
    return jnp.stack(blocks, axis=-2)


def _mutate_small(u, xi, xi_sign, s1, s2):
    """Kelemen exponential small-step (pssmlt_sampler.cpp mutate())."""
    dv = s2 * jnp.exp(-jnp.log(s2 / s1) * xi)
    up = jnp.where(xi_sign < 0.5, u + dv, u - dv)
    return up - jnp.floor(up)  # wrap to [0, 1)


def _splat_px(img, pos, val, weight):
    """Box-filter scatter-add of weighted chain contributions.

    pos: (N, S, 2), val: (N, S, 3), weight: (N,) — each chain's weight is
    shared by its S splats (Kelemen acceptance is on the total luminance).
    """
    H, W = img.shape[0], img.shape[1]
    px = jnp.clip(pos[..., 0].astype(Int), 0, W - 1)
    py = jnp.clip(pos[..., 1].astype(Int), 0, H - 1)
    idx = (py * W + px).reshape(-1)
    contrib = (val * weight[..., None, None]).reshape(-1, 3)
    flat = img.reshape(-1, 3)
    flat = flat.at[idx].add(contrib, mode="drop")
    return flat.reshape(H, W, 3)


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "width", "height", "n_steps", "accumulate"),
    donate_argnames=("img",),
)
def pssmlt_run(scene: Scene, img: jax.Array, state, seed, step0, *, cfg,
               width, height, n_steps, accumulate):
    """Advance every chain by ``n_steps`` Metropolis steps (one jit call).

    state = (table (N,B,4), pos (N,2), color (N,3), I (N,), b_sum, b_cnt).
    When ``accumulate`` both chain states splat into ``img`` each step.
    """
    n_blocks = _n_blocks(cfg)
    n = cfg.n_chains
    chain = jnp.arange(n, dtype=U32)

    def step(i, carry):
        img, table, pos, color, I, b_sum, b_cnt = carry
        t = step0 + i.astype(U32)

        # --- propose ------------------------------------------------------
        fresh = _draw_table(chain, t, seed, n_blocks, stream=1)
        xi = _draw_table(chain, t, seed, n_blocks, stream=2)
        xi_sign = _draw_table(chain, t, seed, n_blocks, stream=3)
        u_misc = _draw_table(chain, t, seed, 1, stream=4)[:, 0, :]
        small = _mutate_small(table, xi, xi_sign, cfg.s1, cfg.s2)
        is_large = u_misc[:, 0] < cfg.p_large
        prop = jnp.where(is_large[:, None, None], fresh, small)

        # --- evaluate -----------------------------------------------------
        pos_p, color_p, I_p = _eval(scene, prop, cfg, width, height)

        # online mean brightness from large steps (the fork's responsive
        # normalization, pssmlt_proc.cpp:338-)
        b_sum = b_sum + jnp.sum(jnp.where(is_large, I_p, 0.0))
        b_cnt = b_cnt + jnp.sum(is_large.astype(Float))

        # --- Metropolis acceptance ----------------------------------------
        a = jnp.where(I > 0, jnp.minimum(1.0, I_p / jnp.maximum(I, 1e-30)),
                      jnp.where(I_p > 0, 1.0, 0.0))

        if accumulate:
            w_cur = jnp.where(I > 0, (1.0 - a) / jnp.maximum(I, 1e-30), 0.0)
            w_prop = jnp.where(I_p > 0, a / jnp.maximum(I_p, 1e-30), 0.0)
            img = _splat_px(img, pos, color, w_cur)
            img = _splat_px(img, pos_p, color_p, w_prop)

        accept = u_misc[:, 1] < a
        table = jnp.where(accept[:, None, None], prop, table)
        pos = jnp.where(accept[:, None, None], pos_p, pos)
        color = jnp.where(accept[:, None, None], color_p, color)
        I = jnp.where(accept, I_p, I)
        return img, table, pos, color, I, b_sum, b_cnt

    carry = (img,) + state
    carry = jax.lax.fori_loop(0, n_steps, step, carry)
    return carry[0], carry[1:]


@functools.partial(jax.jit,
                   static_argnames=("cfg", "width", "height", "lum_rounds"))
def pssmlt_init(scene: Scene, seed, *, cfg, width, height, lum_rounds=8):
    """Bootstrap: luminance pre-pass + seed chains by resampling.

    The analog of the reference's two-stage setup (``pssmlt_proc.cpp``
    luminanceSamples + SeedWorkUnit / ``PathSampler::generateSeeds``):
    ``lum_rounds * n_chains`` independent paths estimate the image
    brightness b (the MCMC normalization constant — by far the largest
    error source on hard-visibility scenes if left to online tracking),
    then the chain ensemble is systematically resampled proportional to
    luminance from the last candidate round so the initial states follow
    the stationary distribution — removing MCMC startup bias.
    """
    n_blocks = _n_blocks(cfg)
    n = cfg.n_chains
    chain = jnp.arange(n, dtype=U32)

    def lum_round(i, acc):
        t = _draw_table(chain, jnp.uint32(0xFFFF0000) + i.astype(U32), seed,
                        n_blocks, stream=0)
        _, _, I_r = _eval(scene, t, cfg, width, height)
        return acc + jnp.sum(I_r)

    b_extra = jax.lax.fori_loop(0, max(lum_rounds - 1, 0), lum_round,
                                jnp.asarray(0.0, Float))

    table = _draw_table(chain, jnp.uint32(0xFFFFFFFF), seed, n_blocks, stream=0)
    pos, color, I = _eval(scene, table, cfg, width, height)
    b_sum = jnp.sum(I) + b_extra
    b_cnt = jnp.asarray(float(n * max(lum_rounds, 1)), Float)

    # systematic resampling over the chain ensemble
    cdf = jnp.cumsum(I)
    total = cdf[-1]
    u0 = mrng._to_unit_float(mrng.hash_u32(seed, U32(0xB00F)))
    targets = (jnp.arange(n, dtype=Float) + u0) / n * total
    idx = jnp.clip(jnp.searchsorted(cdf, targets, side="right"), 0, n - 1)
    table = table[idx]
    pos, color, I = pos[idx], color[idx], I[idx]
    return table, pos, color, I, b_sum, b_cnt


def render_pssmlt(scene: Scene, settings, spp: int | None = None,
                  progress_cb=None) -> np.ndarray:
    """Full PSSMLT render -> (H, W, 3) numpy image.

    ``spp`` is interpreted as mutations-per-pixel (the reference CLI's
    sample count semantics for MLT-family integrators).
    """
    ip = settings.integrator_props
    md = ip.get("max_depth", -1)
    cfg = PSSMLTConfig(
        max_depth=md if md > 0 else 8,
        rr_depth=ip.get("rr_depth", 5),
        p_large=ip.get("p_large", ip.get("luminance_samples_frac", 0.3)),
        n_chains=ip.get("n_chains", 8192),
        burn_in=ip.get("burn_in", 32),
        bidirectional=ip.get("bidirectional", True),
        media_blocks=bool(scene.media.any),
    )
    W, H = settings.width, settings.height
    spp = spp if spp is not None else settings.spp
    total_mut = W * H * spp
    n_steps = max(total_mut // cfg.n_chains, 1)
    seed = jnp.uint32(settings.seed)

    state = pssmlt_init(scene, seed, cfg=cfg, width=W, height=H)
    img = jnp.zeros((H, W, 3), Float)

    burn = min(cfg.burn_in, n_steps // 4) if n_steps > 8 else 0
    if burn:
        img, state = pssmlt_run(scene, img, state, seed, jnp.uint32(1),
                                cfg=cfg, width=W, height=H, n_steps=burn,
                                accumulate=False)

    # chunked accumulation so progress callbacks / interactivity can observe
    chunk = max(min(n_steps - burn, 64), 1)
    done = 0
    remaining = n_steps - burn
    while done < remaining:
        k = min(chunk, remaining - done)
        img, state = pssmlt_run(
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
    return np.asarray(img) * scale
