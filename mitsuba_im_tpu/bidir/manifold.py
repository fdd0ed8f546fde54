"""Batched specular manifold walk (Jakob & Marschner 2012).

Parity target: ``include/mitsuba/bidir/manifold.h`` and
``src/libbidir/manifold.cpp`` (``SpecularManifold::move``/``update``) —
the machinery behind the reference's manifold perturbation mutator
(``src/libbidir/mut_manifold.cpp``): given a transport path containing a
chain of specular vertices, move the chain so the specular constraints
stay satisfied after one endpoint is perturbed.

Wavefront shape: instead of one Newton solve per mutation on one thread,
``manifold_walk`` runs B independent walks in lockstep — every Newton
iteration is one batched constraint evaluation, one batched (2K x 2K)
linear solve (``jnp.linalg.solve`` over the ensemble), and one batched
scene re-projection trace.  The constraint Jacobian is not hand-derived
(the reference builds it from analytic derivatives of the half-vector
frame); we get it exactly with ``jax.jacfwd`` over the tangent-plane
offsets, which is both simpler and covers refraction for free.

Constraint definition (manifold.h "generalized half-vector"): for an
intermediate specular vertex x_i with predecessor x_{i-1} and successor
x_{i+1}, let wi = normalize(x_{i-1} - x_i), wo = normalize(x_{i+1} - x_i)
and h = wi + eta_i * wo.  The vertex is specular-consistent when h is
parallel to the surface normal, i.e. the two tangent-plane components of
normalize(h) vanish.  eta_i = 1 encodes a mirror vertex; eta_i != 1 a
refractive vertex (ratio of indices on the wi side over the wo side).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..core.types import Float
from ..core import math as m


def _normalize(v, eps=1e-20):
    return v * jax.lax.rsqrt(jnp.maximum((v * v).sum(-1, keepdims=True), eps))


def _tangent_frame(n):
    """Duff et al. branchless ONB; n: (..., 3) -> (t, b) each (..., 3)."""
    s = jnp.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = jnp.stack([1.0 + s * n[..., 0] ** 2 * a, s * b, -s * n[..., 0]], -1)
    bt = jnp.stack([b, s + n[..., 1] ** 2 * a, -n[..., 1]], -1)
    return t, bt


def chain_constraints(start, positions, target, normals, eta):
    """Specular constraint vector for one chain.

    start: (3,), positions: (K, 3), target: (3,), normals: (K, 3),
    eta: (K,).  Returns (2K,) tangential half-vector components
    (manifold.h `computeDerivatives` residual).
    """
    prev = jnp.concatenate([start[None], positions[:-1]], axis=0)
    nxt = jnp.concatenate([positions[1:], target[None]], axis=0)
    wi = _normalize(prev - positions)
    wo = _normalize(nxt - positions)
    h = _normalize(wi + eta[:, None] * wo)
    # orient h to the normal's hemisphere so eta<1 refraction is stable
    h = h * jnp.where((h * normals).sum(-1, keepdims=True) < 0.0, -1.0, 1.0)
    t, b = _tangent_frame(normals)
    return jnp.stack([(h * t).sum(-1), (h * b).sum(-1)], -1).reshape(-1)


def _offset_constraints(du, start, positions, target, normals, eta):
    """Constraints after displacing each vertex in its tangent plane."""
    K = positions.shape[0]
    t, b = _tangent_frame(normals)
    disp = du.reshape(K, 2)
    p = positions + disp[:, :1] * t + disp[:, 1:] * b
    return chain_constraints(start, p, target, normals, eta)


def _newton_step(start, positions, target, normals, eta, damping):
    """One tangent-plane Newton step; returns tentative new positions."""
    K = positions.shape[0]
    zero = jnp.zeros(2 * K, positions.dtype)
    f = functools.partial(_offset_constraints, start=start,
                          positions=positions, target=target,
                          normals=normals, eta=eta)
    c = f(zero)
    J = jax.jacfwd(f)(zero)
    # Levenberg-style damping keeps early far-from-manifold steps stable
    J = J + damping * jnp.eye(2 * K, dtype=J.dtype)
    du = -jnp.linalg.solve(J, c).reshape(K, 2)
    t, b = _tangent_frame(normals)
    return positions + du[:, :1] * t + du[:, 1:] * b, jnp.abs(c).max()


def manifold_walk(scene, start, positions, target, eta,
                  n_iter: int = 20, tol: float = 1e-6, damping: float = 0.0):
    """Move a batch of specular chains to satisfy their constraints.

    Batched analog of ``SpecularManifold::move`` (manifold.cpp): endpoints
    ``start``/``target`` are held fixed and the K intermediate specular
    vertices are walked along the scene surfaces until the generalized
    half-vector constraints vanish.

    scene      Scene (used for re-projection traces)
    start      (B, 3) fixed predecessor endpoint of each chain
    positions  (B, K, 3) initial specular vertex positions (on surfaces)
    target     (B, 3) fixed successor endpoint (e.g. the perturbed vertex)
    eta        (B, K) per-vertex relative IOR (1 = mirror)

    Returns (positions, normals, shapes, converged):
      positions (B, K, 3) final vertex positions,
      normals   (B, K, 3) shading normals there,
      shapes    (B, K) shape ids,
      converged (B,) bool — max |constraint| < tol and every re-projection
                 trace hit a surface.
    """
    B, K = positions.shape[0], positions.shape[1]

    def project(prev, tentative, cur_p, cur_n, cur_s, ok):
        """Re-project one tentative vertex: trace prev -> tentative."""
        d = _normalize(tentative - prev)
        it = scene.interaction(prev, d, scene.ray_intersect(prev, d))
        hit = it.valid
        return (jnp.where(hit[:, None], it.p, cur_p),
                jnp.where(hit[:, None], it.ns, cur_n),
                jnp.where(hit, it.shape, cur_s),
                ok & hit)

    def normals_of(p, fallback_n, fallback_s):
        """Initial normals: trace from start through each vertex in turn."""
        prev = start
        ns, ss, ok = [], [], jnp.ones(B, bool)
        n_cur = fallback_n
        s_cur = fallback_s
        for i in range(K):
            pi, ni, si, ok = project(prev, p[:, i], p[:, i],
                                     n_cur[:, i], s_cur[:, i], ok)
            ns.append(ni)
            ss.append(si)
            prev = pi
        return jnp.stack(ns, 1), jnp.stack(ss, 1), ok

    n0 = jnp.zeros_like(positions).at[..., 2].set(1.0)
    s0 = jnp.zeros(positions.shape[:2], jnp.int32)
    normals, shapes, ok0 = normals_of(positions, n0, s0)

    step_b = jax.vmap(_newton_step, in_axes=(0, 0, 0, 0, 0, None))

    def body(_, carry):
        p, n, s, ok, scale = carry
        r_old = jnp.abs(jax.vmap(chain_constraints)(
            start, p, target, n, eta)).max(-1)
        tent, _resid = step_b(start, p, target, n, eta, damping)
        # per-lane backtracking scale (damped Newton)
        tent = p + scale[:, None, None] * (tent - p)
        # sequential re-projection along the chain keeps vertices on the
        # true manifold (tangent steps alone leave the surface)
        prev = start
        new_p, new_n, new_s = [], [], []
        okp = ok
        for i in range(K):
            pi, ni, si, okp = project(prev, tent[:, i], p[:, i], n[:, i],
                                      s[:, i], okp)
            new_p.append(pi)
            new_n.append(ni)
            new_s.append(si)
            prev = pi
        p2 = jnp.stack(new_p, 1)
        n2 = jnp.stack(new_n, 1)
        s2 = jnp.stack(new_s, 1)
        # step control (SpecularManifold::move's trust-region analog):
        # accept only steps that reduce the constraint residual — the raw
        # Newton+reproject update can jump to the wrong surface or
        # amplify f32 noise through near-grazing chords, walking AWAY
        # from an already-converged chain otherwise.  Rejected lanes
        # halve their step (backtracking) and retry next iteration;
        # accepted lanes reset to full steps.  Walks that lost a surface
        # keep their previous state.
        r_new = jnp.abs(jax.vmap(chain_constraints)(
            start, p2, target, n2, eta)).max(-1)
        accept = okp & (r_new < r_old)
        scale = jnp.where(accept, 1.0, jnp.maximum(scale * 0.5, 1.0 / 64.0))
        keep = accept[:, None, None]
        return (jnp.where(keep, p2, p), jnp.where(keep, n2, n),
                jnp.where(keep[:, :, 0], s2, s), ok, scale)

    p, n, s, _, _ = jax.lax.fori_loop(
        0, n_iter, body,
        (positions, normals, shapes, ok0,
         jnp.ones(positions.shape[0], positions.dtype)))

    resid = jax.vmap(chain_constraints)(start, p, target, n, eta)
    converged = ok0 & (jnp.abs(resid).max(-1) < tol)
    return p, n, s, converged


def manifold_map_jacobian(start, positions, target, normals, eta,
                          target_frame=None, damping=0.0):
    """Derivative of the specular chain through the manifold map.

    The transition density Q of a manifold perturbation
    (``/root/reference/src/libbidir/mut_manifold.cpp`` via
    ``SpecularManifold::det``) needs the Jacobian of the *manifold map*:
    how the chain's first specular vertex moves (in its tangent plane) as
    the ``target`` endpoint moves (in its tangent plane) while the
    generalized half-vector constraints stay satisfied.  By the implicit
    function theorem on c(du_chain; dt_target) = 0:

        d(du_chain)/d(dt_target) = -J_chain^{-1} @ dc/d(dt_target)

    both derivatives taken exactly with ``jax.jacfwd`` through the same
    constraint function the Newton solver uses (no hand-derived frames).

    start:  (3,) fixed predecessor endpoint;
    positions: (K, 3) ON-MANIFOLD specular vertices (walk first);
    target: (3,) successor endpoint; normals (K, 3); eta (K,).
    target_frame: optional (t, b) each (3,) — tangent frame at the target
    (defaults to a Duff ONB around the start->target direction, which is
    what a perturbation-in-screen-space proposal uses).

    Returns (J_first (2, 2), J_full (2K, 2)): the first vertex's tangent
    response and the full chain response.
    """
    K = positions.shape[0]
    if target_frame is None:
        tdir = _normalize(target - start)
        tf_t, tf_b = _tangent_frame(tdir)
    else:
        tf_t, tf_b = target_frame

    def c_of(du, dt):
        tgt = target + dt[0] * tf_t + dt[1] * tf_b
        return _offset_constraints(du, start, positions, tgt, normals, eta)

    zero_u = jnp.zeros(2 * K, positions.dtype)
    zero_t = jnp.zeros(2, positions.dtype)
    J_u = jax.jacfwd(c_of, argnums=0)(zero_u, zero_t)
    J_t = jax.jacfwd(c_of, argnums=1)(zero_u, zero_t)
    J_u = J_u + damping * jnp.eye(2 * K, dtype=J_u.dtype)
    J_full = -jnp.linalg.solve(J_u, J_t)  # (2K, 2)
    return J_full[:2, :], J_full


def manifold_map_det(start, positions, target, normals, eta,
                     target_frame=None):
    """|det| of the 2x2 target->first-vertex manifold map — the density
    conversion factor in a manifold mutation's Q (``mut_manifold.cpp``:
    the ``det`` the reference multiplies into its proposal density).

    Reciprocity: for on-manifold states, the forward determinant (seen
    from one endpoint) is the reciprocal of the reverse determinant of
    the inverse map, which is what makes a Q built from it satisfy
    detailed balance; tests/test_manifold.py verifies both this and the
    finite-difference consistency of the Jacobian against the actual
    Newton walk.
    """
    J2, _ = manifold_map_jacobian(start, positions, target, normals, eta,
                                  target_frame)
    return jnp.abs(J2[0, 0] * J2[1, 1] - J2[0, 1] * J2[1, 0])


def reflection_constraint_ok(start, positions, target, normals, eta,
                             tol=1e-4):
    """Convenience checker used by tests and path verification
    (src/libbidir/verification.cpp analog for specular chains)."""
    resid = jax.vmap(chain_constraints)(start, positions, target,
                                        normals, eta)
    return jnp.abs(resid).max(-1) < tol
