# coding=utf-8
"""Linearized (eigenvalue) buckling analysis.

Framework extension (the reference is a dynamics-only simulator with no
stability analysis of any kind — /root/reference/main.py drives time
integration only): predict the critical load multiplier at which a
preloaded structure loses stability, the classic FEM "eigenvalue buckling"
step next to statics (solvers/static.py) and modal analysis
(solvers/modal.py).

Formulation — the standard two-point linearization (what commercial codes
run as "linear buckling with preload"): let K(x) = ∂²U/∂x² be the exact
tangent stiffness,

    K₀   = K at the unloaded reference pose x₀,
    K₁   = K at the equilibrium x₁ of the UNIT applied load f
           (solved by the damped-Newton statics solver),
    K_g  = K₁ − K₀          (stress/geometric stiffness of the unit load).

Assuming stress grows linearly with the load multiplier λ, the tangent on
the primary path is K(λ) ≈ K₀ + λ·K_g, and buckling is its first
singularity:

    (K₀ + λ K_g) φ = 0        ⇔        K_g φ = μ K₀ φ,   λ = −1/μ.

Destabilizing directions are the NEGATIVE pencil eigenvalues μ; the
critical multiplier is λ_cr = −1/μ_min, and λ ascending corresponds to μ
ascending (most negative first).

Design — everything matrix-free, mirrors solvers/modal.py:

  * K₀·v and K₁·v via ``jax.jvp`` of the assembled analytic elastic force
    (modal.make_stiffness_hvp — exact for every material, O(E) per apply);
  * Dirichlet pins projected the standard way (K₀ ← P·K₀·P + (I−P),
    K_g ← P·K_g·P) so held DOFs sit at μ = 0, outside both spectral tails;
  * the smallest (most negative) μ by SHIFTED block subspace iteration on
    W = σI − K₀⁻¹K_g with σ adapted to the largest Ritz value each round
    (σ − μ is then maximal and positive exactly at μ_min — plain power
    iteration would chase the largest |μ| of either sign), K₀⁻¹ applied by
    a blocked inner CG, followed by a dense kq×kq Rayleigh–Ritz solve of
    the projected pencil (Ĝ, K̂) each round;
  * each round is one bounded jitted program, with a host-side early stop
    on the wanted residuals.

Validated against a dense float64 generalized-eigenvalue oracle assembled
column-by-column from the same HVPs, an Euler-column slenderness scaling
law, and tension (no positive critical factor) in tests/test_buckling.py.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from fem_tpu.models.state import FemObject
from fem_tpu.solvers.modal import make_stiffness_hvp
from fem_tpu.solvers.static import StaticResult, gravity_force, solve_static

# Full-f32 products: a float32 matmul may otherwise run in TF32 on GPUs.
_mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)


class BucklingResult(NamedTuple):
    """Critical load multipliers sorted ascending (most critical first).

    ``load_factors``: (k,) multipliers λ of the applied load at which
    K₀ + λ·K_g goes singular; +inf where the subspace found no
    destabilizing direction (e.g. tensile loading).
    ``mu``: (k,) pencil eigenvalues K_g φ = μ K₀ φ (λ = −1/μ; negative μ
    = buckling direction).
    ``modes``: (k, N, dim) buckling mode shapes, K₀-orthonormal, zero on
    pinned DOFs.
    ``residuals``: (k,) relative pencil residuals
    ‖K_gφ − μK₀φ‖ / (‖K_gφ‖ + |μ|‖K₀φ‖).
    ``base``: the unit-load static equilibrium (StaticResult) the stress
    stiffness was linearized at.
    """

    load_factors: jnp.ndarray
    mu: jnp.ndarray
    modes: jnp.ndarray
    residuals: jnp.ndarray
    base: StaticResult


def linear_buckling(
    obj: FemObject,
    pos0: jnp.ndarray,
    f_ext: Optional[jnp.ndarray] = None,
    g_dir: Optional[Tuple[float, ...]] = None,
    k: int = 4,
    rounds: int = 16,
    inner_iters: int = 400,
    target_tol: float = 1e-3,
    seed: int = 0,
    base: Optional[StaticResult] = None,
    static_kwargs: Optional[dict] = None,
) -> BucklingResult:
    """Smallest-``k`` critical load factors of ``obj`` under the given load.

    The applied load is ``f_ext`` (per-vertex, (N, d)) plus gravity along
    ``g_dir`` plus any built-in Neumann loads (``obj.static_load`` from
    ObjectConfig.load_boxes) — ALL of it scales together by λ, the standard
    eigenvalue-buckling assumption.  Requires Dirichlet pins
    (``obj.free_mask``), inherited from the statics solver.

    ``base`` re-uses an already-solved unit-load equilibrium; otherwise
    :func:`solve_static` runs first (``static_kwargs`` forwarded).  ``k``
    internal guard vectors are added on top of the wanted ``k``.  Each
    subspace round costs ~``inner_iters``·kq + 4·kq stiffness HVPs.
    """
    if obj.free_mask is None:
        raise ValueError(
            "linear_buckling requires Dirichlet constraints "
            "(ObjectConfig.pin_boxes / obj.free_mask), same as solve_static"
        )
    n, d = pos0.shape
    nd = n * d
    kq = min(k + max(4, k), max(k + 1, nd // 3))
    if kq < k:
        raise ValueError(f"mesh too small for k={k} buckling modes (nd={nd})")

    load = jnp.zeros_like(pos0)
    if f_ext is not None:
        load = load + f_ext
    if g_dir is not None:
        load = load + gravity_force(obj, g_dir)
    if base is None:
        base = solve_static(
            obj, pos0, f_ext=f_ext, g_dir=g_dir, **(static_kwargs or {})
        )
    pos1 = base.pos

    kv0 = make_stiffness_hvp(obj, pos0)
    kv1 = make_stiffness_hvp(obj, pos1)
    free = obj.free_mask.astype(pos0.dtype)  # (N, 1)
    free_flat = jnp.repeat(free[:, 0], d)  # (nd,)

    def a0_single(y: jnp.ndarray) -> jnp.ndarray:
        """P·K₀·P + (I−P) on one flat vector (SPD at a stable rest pose)."""
        v = (y * free_flat).reshape(n, d)
        w = (kv0(v) * free).reshape(nd)
        return w + (y - y * free_flat)

    def g_single(y: jnp.ndarray) -> jnp.ndarray:
        """P·(K₁ − K₀)·P: the stress/geometric stiffness of the unit load."""
        v = (y * free_flat).reshape(n, d)
        w = ((kv1(v) - kv0(v)) * free).reshape(nd)
        return w

    a0_block = jax.vmap(a0_single, in_axes=1, out_axes=1)
    g_block = jax.vmap(g_single, in_axes=1, out_axes=1)

    def solve_a0_block(rhs: jnp.ndarray) -> jnp.ndarray:
        """K₀⁻¹ · RHS via blocked CG, all kq columns together (fixed
        iteration count: one bounded traced loop, no host round-trips)."""
        x = jnp.zeros_like(rhs)
        r = rhs
        p = r
        rs = jnp.sum(r * r, axis=0)

        def body(_, carry):
            x, r, p, rs = carry
            ap = a0_block(p)
            denom = jnp.sum(p * ap, axis=0)
            alpha = rs / jnp.where(denom > 0, denom, 1.0)
            x = x + alpha[None, :] * p
            r = r - alpha[None, :] * ap
            rs_new = jnp.sum(r * r, axis=0)
            beta = rs_new / jnp.where(rs > 0, rs, 1.0)
            p = r + beta[None, :] * p
            return x, r, p, rs_new

        x, _, _, _ = jax.lax.fori_loop(0, inner_iters, body, (x, r, p, rs))
        return x

    @jax.jit
    def one_round(x: jnp.ndarray, sigma: jnp.ndarray):
        # Shifted iteration W·X = σX − K₀⁻¹(K_g X): σ − μ is largest and
        # positive at the most NEGATIVE pencil eigenvalue.
        y = sigma * x - solve_a0_block(g_block(x))
        y = y / (jnp.linalg.norm(y, axis=0, keepdims=True) + 1e-30)
        q, _ = jnp.linalg.qr(y)
        # Rayleigh–Ritz on the pencil (Ĝ, K̂), K̂ SPD.
        aq = a0_block(q)
        gq = g_block(q)
        k_hat = _mm(q.T, aq)
        g_hat = _mm(q.T, gq)
        k_hat = 0.5 * (k_hat + k_hat.T)
        g_hat = 0.5 * (g_hat + g_hat.T)
        jitter = 1e-6 * (jnp.trace(k_hat) / kq)
        chol = jnp.linalg.cholesky(
            k_hat + jitter * jnp.eye(kq, dtype=k_hat.dtype)
        )
        inv_l = jax.scipy.linalg.solve_triangular(
            chol, jnp.eye(kq, dtype=k_hat.dtype), lower=True
        )
        mu, s = jnp.linalg.eigh(_mm(_mm(inv_l, g_hat), inv_l.T))  # ascending
        s = _mm(inv_l.T, s)  # back to the q basis; K̂-orthonormal columns
        x_new = _mm(q, s)
        # Residuals of the wanted (leading ascending) Ritz pairs.
        gx = _mm(gq, s)
        ax = _mm(aq, s)
        num = jnp.linalg.norm(gx - mu[None, :] * ax, axis=0)
        den = (
            jnp.linalg.norm(gx, axis=0)
            + jnp.abs(mu) * jnp.linalg.norm(ax, axis=0)
        )
        res = num / (den + 1e-30)
        sigma_next = jnp.maximum(mu[-1], 0.0)
        return x_new, mu, res, sigma_next

    key = jax.random.PRNGKey(seed)
    x = jax.random.normal(key, (nd, kq), pos0.dtype) * free_flat[:, None]
    sigma = jnp.asarray(0.0, pos0.dtype)
    mu = res = None
    for r in range(rounds):
        x, mu, res, sigma = one_round(x, sigma)
        if r >= 2 and bool(jnp.max(res[:k]) < target_tol):
            break

    mu_k = mu[:k]
    tiny = 1e-12
    factors = jnp.where(mu_k < -tiny, -1.0 / jnp.where(mu_k < -tiny, mu_k, -1.0), jnp.inf)
    modes = jnp.moveaxis(x[:, :k].reshape(n, d, k), -1, 0)
    return BucklingResult(
        load_factors=factors,
        mu=mu_k,
        modes=modes,
        residuals=res[:k],
        base=base,
    )
