# coding=utf-8
"""Quasi-static equilibrium solver (framework extension).

The reference is a dynamics-only simulator (its main loop integrates
velocities every substep, main.py:101-113); classic FEM use cases — sag of a
pinned part under gravity, prescribed-displacement loading, patch tests —
need the *static* problem

    min_x  Π(x) = U(x) − f_extᵀ·x     subject to  x_pinned fixed,

solved here by damped Newton with the Dirichlet projection of the exact
elastic Hessian (any material, via ``jax.jvp`` of the analytic Piola
gradient — the same exact-Newton machinery as ``hessian="exact_jvp"``,
solvers/implicit.py) and a backtracking line search on the total potential.
The whole solve is one jitted ``lax.while_loop``: fixed-shape iterations,
no host round-trips.

Requires ``obj.free_mask`` (ObjectConfig.pin_boxes) — an unconstrained
elastic body has a rigid-translation null space and no unique equilibrium.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from fem_tpu.models.state import FemObject
from fem_tpu.ops.assembly import assemble_for, element_contrib_full
from fem_tpu.ops.element import explicit_grad_columns, total_energy
from fem_tpu.solvers.implicit import conjugate_gradient


class StaticResult(NamedTuple):
    pos: jnp.ndarray  # (N, d) equilibrium positions
    iterations: jnp.ndarray  # Newton iterations taken
    grad_norm: jnp.ndarray  # final max |projected residual force|
    energy: jnp.ndarray  # final total potential Π
    converged: jnp.ndarray  # bool: grad_norm ≤ the effective tolerance
    stalled: jnp.ndarray  # bool: stopped at the f32 progress floor instead
    cg_iterations: jnp.ndarray = jnp.int32(0)  # total inner CG iterations


def gravity_force(
    obj: FemObject, g_dir: Tuple[float, ...]
) -> jnp.ndarray:
    """Per-vertex gravity load f = m·9.8·ĝ — the static counterpart of the
    dynamic paths' 9.8·g_dir acceleration (solver/kinematic.py:17)."""
    g = 9.8 * jnp.asarray(g_dir, jnp.float32)
    return obj.mass[:, None] * g[None, :]


def solve_static(
    obj: FemObject,
    pos0: jnp.ndarray,
    f_ext: jnp.ndarray | None = None,
    g_dir: Tuple[float, ...] | None = None,
    tol: float = 1e-5,
    max_newton: int = 60,
    cg_iters: int = 400,
    n_backtrack: int = 12,
    cg_precond: str = "none",
) -> StaticResult:
    """Solve for static equilibrium from initial guess ``pos0``.

    Pinned vertices (``obj.free_mask`` = 0) are held at their ``pos0``
    positions — prescribed-displacement loading is expressed by moving them
    before the call.  ``f_ext`` is an additional per-vertex load (N, d);
    ``g_dir`` adds gravity via :func:`gravity_force`.

    Newton iteration with:
      * exact Hessian-vector products H·v = ∂²U/∂x² · v (jvp of the analytic
        energy gradient — exact for every material, incl. corotated through
        the tie-robust polar);
      * Dirichlet-projected, Levenberg-damped CG solve
        (P·H·P + (I−P) + λ·P)·δ = −P·g, λ adapted ×8 up / ×4 down on line
        search failure/success (handles indefinite H far from equilibrium);
      * backtracking line search on Π over t = 1, ½, …, 2^{1−n_backtrack},
        accepting the largest step with Π(x+tδ) < Π(x) (NaN-safe: an
        inverted-element NaN energy is treated as +inf and rejected).

    Converged when max |P·g| ≤ max(``tol``, the f32 residual floor estimate
    ε₃₂ · Vₘₐₓ · (μ+λ) · ‖R⁻¹‖ₘₐₓ · 16 — the cancellation scale inside the
    float32 element chain (P = μF − μF⁻ᵀ + …); the true floor is mesh- and
    valence-dependent, so the solver ALSO stops with ``stalled=True`` after
    3 consecutive line-search failures — no float32-representable step can
    reduce the residual further (the scipy "xtol reached" analogue).  The
    achieved residual is always reported in ``grad_norm``; position accuracy
    at a stall is ~grad_norm/K — orders of magnitude tighter than the
    displacement field itself (verified by the patch tests).
    """
    if obj.free_mask is None:
        raise ValueError(
            "solve_static requires Dirichlet constraints (ObjectConfig."
            "pin_boxes / obj.free_mask): an unconstrained body has a "
            "rigid-motion null space and no unique equilibrium"
        )
    from fem_tpu.solvers.multilevel import parse_two_level_precond

    use_two_level, tl_smoother, tl_degree = parse_two_level_precond(
        cg_precond
    )
    if cg_precond != "none" and not use_two_level:
        raise ValueError(
            f"solve_static cg_precond must be 'none' or 'two_level[...]', "
            f"got {cg_precond!r}"
        )
    if use_two_level and obj.agg_ids is None:
        raise ValueError(
            "cg_precond='two_level' needs the coarse space attached at "
            "build time (models/state.build_object)"
        )
    free = obj.free_mask  # (N, 1)
    held = 1.0 - free
    load = jnp.zeros_like(pos0)
    if f_ext is not None:
        load = load + f_ext
    if g_dir is not None:
        load = load + gravity_force(obj, g_dir)
    if obj.static_load is not None:
        # Neumann loads (ObjectConfig.load_boxes) are part of the
        # equilibrium the dynamics relaxes to — include them always.
        load = load + obj.static_load

    def energy_grad(p: jnp.ndarray) -> jnp.ndarray:
        cols = explicit_grad_columns(
            p, obj.element_indices, obj.ref_inv, obj.volume,
            obj.mu, obj.s_lambda, obj.material,
        )
        return assemble_for(obj, element_contrib_full(cols), None)

    def potential(p: jnp.ndarray) -> jnp.ndarray:
        u = total_energy(
            p, obj.element_indices, obj.ref_inv, obj.volume,
            obj.mu, obj.s_lambda, obj.material,
        )
        return u - jnp.sum(load * p)

    def residual(p: jnp.ndarray) -> jnp.ndarray:
        return free * (energy_grad(p) - load)

    tl_setup = None
    if use_two_level:
        # Coarse-space preconditioner (solvers/multilevel.py), built ONCE
        # at pos0 and FROZEN across Newton iterates: the static operator
        # has NO mass regularization — its conditioning is the raw
        # elliptic (L/h)², exactly the regime the coarse space owns — and
        # the per-iterate rebuild (decoupled blocks + coarse Cholesky +
        # power-iterated ω) would cost more than the whole plain solve.
        # Frozen-preconditioner staleness under the
        # moderate deformations of a statics solve costs iterations, not
        # correctness (the operator stays the exact HVP at the current
        # iterate; ω's 0.7 safety absorbs the λmax drift).
        from fem_tpu.ops.element import hessian_blocks
        from fem_tpu.solvers.multilevel import (
            coarse_matrix, make_coarse_space, static_diag_blocks,
            two_level_setup,
        )

        k_dec0 = hessian_blocks(
            pos0, obj.element_indices, obj.ref_inv, obj.volume,
            obj.mu, obj.s_lambda, True, obj.material,
        )
        diag0 = static_diag_blocks(obj, k_dec0, jnp.float32(0.0))
        eye0 = jnp.eye(obj.dim, dtype=diag0.dtype)[None]
        f30 = free[..., None]
        diag0 = f30 * diag0 + (1.0 - f30) * eye0
        coarse0 = make_coarse_space(obj)
        c_mat0 = coarse_matrix(
            coarse0, obj, k_dec0, 0.0, free_mask=free, coeff=1.0,
            mass_vec=jnp.zeros_like(obj.mass),
        )

        def energy_grad0(p):
            cols = explicit_grad_columns(
                p, obj.element_indices, obj.ref_inv, obj.volume,
                obj.mu, obj.s_lambda, obj.material,
            )
            return assemble_for(obj, element_contrib_full(cols), None)

        def op0(v):
            hv = jax.jvp(energy_grad0, (pos0,), (free * v,))[1]
            return free * hv + (1.0 - free) * v

        tl_setup = two_level_setup(
            diag0, jnp.ones_like(obj.mass), coarse0, c_mat0, free,
            operator=op0,
        )

    ts = 2.0 ** (-jnp.arange(n_backtrack, dtype=jnp.float32))  # 1, ½, …
    rinv_norm = jnp.sqrt(
        jnp.max(jnp.sum(obj.ref_inv * obj.ref_inv, axis=(-2, -1)))
    )
    f32_floor = (
        1.2e-7
        * jnp.max(obj.volume)
        * (abs(obj.mu) + abs(obj.s_lambda))
        * rinv_norm
    )
    tol_eff = jnp.maximum(jnp.float32(tol), 16.0 * f32_floor)

    def body(carry):
        x, lam, it, _, _, fails, cg_total = carry
        g = residual(x)

        def hvp(v):
            return jax.jvp(energy_grad, (x,), (v,))[1]

        def op(v):
            return free * (hvp(free * v) + lam * v) + held * v

        gg = jnp.sum(g * g)
        # Relative CG tolerance on rᵀr (the Newton inner solve needs only a
        # direction; 1e-8 relative is far below line-search resolution).
        inner_tol = 1e-8 * gg
        if use_two_level:
            # V-cycle PCG on the exact HVP with the pos0-frozen setup
            # (built above).  The internal residual applies are the exact
            # operator at the CURRENT iterate — the earlier decoupled-
            # surrogate ω (power-iterated on a DIFFERENT operator than
            # the cycle applies) under-damped the smoother against the
            # exact Hessian's sharper top, turned M indefinite, and
            # stalled the slab solve.
            from fem_tpu.solvers.multilevel import two_level_pcg

            ones = jnp.ones_like(obj.mass)
            sol = two_level_pcg(
                op, None, ones, None, None, -g, jnp.zeros_like(g),
                max_iter=cg_iters, tol=inner_tol, free_mask=free,
                setup=tl_setup, smoother=tl_smoother,
                cheb_degree=tl_degree,
            )
        else:
            sol = conjugate_gradient(
                op, -g, jnp.zeros_like(g), max_iter=cg_iters,
                tol=inner_tol,
            )
        delta = sol.x
        e0 = potential(x)
        g0n = jnp.max(jnp.abs(g))
        cand = x[None] + ts[:, None, None] * delta[None]
        e_t = jax.vmap(potential)(cand)
        e_t = jnp.where(jnp.isnan(e_t), jnp.inf, e_t)
        g_t = jax.vmap(lambda c: jnp.max(jnp.abs(residual(c))))(cand)
        g_t = jnp.where(jnp.isnan(g_t), jnp.inf, g_t)
        # Acceptance: the residual norm must DROP; the potential acts only as
        # a coarse divergence guard.  Near the optimum the f32 energy value
        # carries ~1e-4·|Π| cancellation noise (φ = μ/2·(I_C − d) − … with
        # I_C ≈ d), far above the true energy differences, while the
        # residual — an absolute quantity heading to 0 — remains reliable
        # down to the f32 assembly floor (~1e-6 of element-force scale).
        slack = 1e-4 * (jnp.abs(e0) + 1.0)
        improved = (g_t < g0n) & (e_t <= e0 + slack)
        # Largest accepted step (ts is descending).
        first = jnp.argmax(improved)
        any_ok = jnp.any(improved)
        x_new = jnp.where(any_ok, cand[first], x)
        lam_scale = jnp.asarray(
            jnp.max(jnp.abs(obj.mu)) + jnp.max(jnp.abs(obj.s_lambda)),
            jnp.float32,
        )
        lam_new = jnp.where(
            any_ok, jnp.maximum(lam / 4.0, 0.0),
            jnp.maximum(lam * 8.0, 1e-6 * lam_scale),
        )
        g_new = residual(x_new)
        gnorm = jnp.max(jnp.abs(g_new))
        fails_new = jnp.where(any_ok, jnp.int32(0), fails + 1)
        return (
            x_new, lam_new, it + 1, gnorm, potential(x_new), fails_new,
            cg_total + sol.iterations,
        )

    def cond(carry):
        _, _, it, gnorm, _, fails, _ = carry
        return (it < max_newton) & (gnorm > tol_eff) & (fails < 3)

    g0 = residual(pos0)
    carry0 = (
        pos0, jnp.float32(0.0), jnp.int32(0),
        jnp.max(jnp.abs(g0)), potential(pos0), jnp.int32(0), jnp.int32(0),
    )
    x, _, it, gnorm, e_fin, fails, cg_total = jax.lax.while_loop(
        cond, body, carry0
    )
    return StaticResult(
        pos=x, iterations=it, grad_norm=gnorm, energy=e_fin,
        converged=gnorm <= tol_eff,
        stalled=(fails >= 3) & (gnorm > tol_eff),
        cg_iterations=cg_total,
    )


def make_static_solve_fn(obj: FemObject, **kwargs):
    """Jitted ``solve(pos0, f_ext=None) -> StaticResult`` closure; the mesh
    arrays ride as jit arguments (never closure constants — see the NOTE in
    fem_tpu/sim.py)."""

    @jax.jit
    def impl(o: FemObject, pos0, f_ext):
        return solve_static(o, pos0, f_ext=f_ext, **kwargs)

    def solve(pos0, f_ext=None):
        if f_ext is None:
            f_ext = jnp.zeros_like(pos0)
        return impl(obj, pos0, f_ext)

    return solve


def solve_static_chunked(
    obj: FemObject,
    pos0: jnp.ndarray,
    f_ext: jnp.ndarray | None = None,
    chunk_newton: int = 2,
    max_newton: int = 60,
    plateau_rtol: float = 1e-3,
    **kwargs,
) -> StaticResult:
    """Host-chunked static solve: the solve as repeated warm-started device
    programs of ``max_newton=chunk_newton`` Newton steps each, which bounds
    the length of any one device program and lets the host stop on a
    plateau.

    Two behaviors the naive restart loop gets wrong, handled here:

    * warm-restarted calls RESET solve_static's internal 3-consecutive-
      line-search-failure stall counter, so the inner ``stalled`` flag
      can never trip across restarts — the f32-floor plateau is instead
      detected on the host: a chunk that improves ``grad_norm`` by less
      than ``plateau_rtol`` (relative) ends the loop with
      ``stalled=True``;
    * iteration / inner-CG counts accumulate across chunks, so the
      returned ``StaticResult`` reads like a single solve.

    The Levenberg damping state also resets per chunk (mildly wasteful,
    never wrong — λ re-adapts within an iteration or two).  For meshes
    where one program is fine, prefer :func:`solve_static` (identical
    math, no restart loss)."""
    import numpy as np

    solve = make_static_solve_fn(
        obj, max_newton=chunk_newton, **kwargs
    )
    pos = pos0
    tot_newton = 0
    tot_cg = 0
    prev_grad = float("inf")
    res = None
    stalled = False
    while tot_newton < max_newton:
        res = solve(pos, f_ext)
        g = float(res.grad_norm)
        pos = res.pos
        tot_newton += int(res.iterations)
        tot_cg += int(res.cg_iterations)
        if bool(res.converged) or bool(res.stalled):
            stalled = bool(res.stalled)
            break
        if not np.isfinite(g) or g >= prev_grad * (1.0 - plateau_rtol):
            stalled = True  # host-detected f32 progress floor
            break
        prev_grad = g
    return StaticResult(
        pos=res.pos,
        iterations=jnp.int32(tot_newton),
        grad_norm=res.grad_norm,
        energy=res.energy,
        converged=res.converged,
        stalled=jnp.bool_(stalled and not bool(res.converged)),
        cg_iterations=jnp.int32(tot_cg),
    )
