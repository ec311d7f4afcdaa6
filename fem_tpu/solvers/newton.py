# coding=utf-8
"""Fully implicit (true Newton) backward-Euler velocity solve.

Framework extension (``SimConfig.integrator = "newton"``).  The reference's
implicit method performs ONE linearized solve per substep — backward Euler
linearized at the beginning-of-step positions (semi-implicit;
/root/reference/solver/implicit.py:201-223) — which is why it blows up when
κ = dt²·‖K‖/m approaches 1: the linearization error of the single solve, not
the linear algebra, is what diverges (68k tets NaN at the config-default
dt=5e-4, the reference's own spot.obj at t≈5 s, 212k at dt=1.5e-4; neither
robust inversion nor an exact single-solve Hessian rescues it, both
probed).  This solver closes the nonlinear residual
instead:

    r(v) = (v − v_n) − dt·M⁻¹·f_el(x_n + dt·v)  =  0

(the true backward-Euler condition on the elastic term; equivalently the
stationarity of the incremental potential
I(v) = ½‖v − v_n‖²_M + U(x_n + dt·v)).  Gravity, damping and collisions stay
in the advection step exactly as the reference structures them
(solver/implicit.py:407-438), so ``integrator="newton"`` changes only how
far the elastic force is trusted — the surrounding substep anatomy is
unchanged and external forces / Neumann loads / contact fold in through the
same rhs velocity substitution as the semi-implicit path.

Design: one jitted ``lax.while_loop`` over damped Newton steps —
each step solves J·δ = −r matrix-free by CG and backtracks on the residual
norm (sequentially: the full step is accepted on the first trial away from
the stability boundary, so the common-case cost is one extra force
evaluation).  NaN residuals (an inversion attempt under plain neo-Hookean's
log) read as +inf and are rejected, which is what makes the method robust
where the reference NaNs.  Everything is fixed-shape; element assemblies
psum over ``axis_name`` under shard_map and the particle-space Newton/CG
iterations run replicated — the same sharding contract as the semi-implicit
paths.

Two Jacobians (``SimConfig.newton_hessian``):

* ``"exact"`` — J = I + dt²·M⁻¹·K(x) with K·w the exact material-generic
  Hessian-vector product (``jax.jvp`` of the assembled analytic force, the
  ``hessian="exact_jvp"`` machinery).  Quadratic convergence; every
  force/HVP rides the XLA gather/segment-sum graph chain.
* ``"decoupled"`` — modified Newton on the reference's own decoupled
  one-block-per-element linearization: each Newton step IS one
  semi-implicit-shaped solve on the graph operator, and ONE element pass
  yields both the residual force and the operator's K blocks.
  Convergence drops to superlinear-at-best, but each iteration runs at
  semi-implicit speed — the fast path at scale.

Cost model: at reference-stable dt the first Newton step already satisfies
the tolerance most substeps, so the overhead is ~one extra force
evaluation; the win is that dt is no longer capped by the mesh size
(dt ~ h removed).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from fem_tpu.models.state import FemObject, SimState
from fem_tpu.ops.assembly import assemble_for, element_contrib_full
from fem_tpu.solvers.implicit import (
    ImplicitAux,
    _material_force_columns,
    conjugate_gradient,
    diagonal_blocks_from,
    make_system_apply,
    preconditioned_conjugate_gradient,
)


def _decoupled_prep(
    obj: FemObject, pos: jnp.ndarray, axis_name, robust: bool = False,
    layers=None,
):
    """(assembled elastic force f, element K blocks) at ``pos`` — one element
    pass yields both.  ``layers`` (ops/inelastic.material_layers) sums force
    and K over material layers at the frozen internal variables."""
    from fem_tpu.solvers.implicit import _k_and_force_cols_layers

    k_flat, cols = _k_and_force_cols_layers(
        obj, pos, obj.element_indices, obj.ref_inv, obj.volume, robust,
        layers, axis_name=axis_name,
    )
    f = assemble_for(obj, element_contrib_full(cols), axis_name)
    return f, k_flat


def _decoupled_minv_gk(obj: FemObject, k_flat: jnp.ndarray, axis_name):
    """w ↦ M⁻¹·G(K)·w from stored K blocks — the raw decoupled
    force-Jacobian product (used for the Rayleigh damping force in the
    Newton residual)."""
    from fem_tpu.solvers.implicit import graph_block_apply

    def apply_gk(w: jnp.ndarray) -> jnp.ndarray:
        return graph_block_apply(obj, k_flat, w, axis_name) / obj.mass[:, None]

    return apply_gk


def newton_velocity_solve(
    obj: FemObject,
    state: SimState,
    dt: float,
    axis_name: str | None = None,
    max_newton: int = 10,
    cg_iters: int = 120,
    tol: float = 1e-5,
    n_backtrack: int = 10,
    hessian_mode: str = "exact",
    cg_precond: str = "none",
    robust: bool = False,
    beta: float = 0.0,
    theta: float = 1.0,
    layers=None,
    v_n_pos: jnp.ndarray | None = None,
) -> Tuple[SimState, ImplicitAux]:
    """Solve r(v) = 0 for the end-of-substep velocity; vel ← v.

    Convergence: max |P·r| ≤ ``tol`` (velocity units — matches the scale of
    the reference CG's absolute tolerance on the same unknown), or
    ``max_newton`` steps, or 3 consecutive line-search failures (the f32
    progress floor, as in solvers/static.py).  The inner CG runs inexactly
    (1e-4 relative forcing) — a Newton step needs a direction, not a tight
    solve.  Reported aux: total inner CG iterations (comparable with the
    semi-implicit paths' iteration counter) and the final ‖P·r‖².

    ``cg_precond="block_jacobi"`` applies the mass-symmetrized block-Jacobi
    PCG (solvers/implicit.preconditioned_conjugate_gradient) to the inner
    solves — decoupled mode only (the diagonal blocks fall out of the prep
    tables; the exact-HVP mode assembles no diagonal).  The lever for the
    ill-conditioned large-dt regimes where plain CG needs ~100
    iterations/substep.

    ``beta`` (Rayleigh damping extension, ObjectConfig.damping_beta) adds
    the damping force β·G(K(x))·v to the residual —
    r(v) = (v−vₙ) − dt·M⁻¹·[f_el(x) + β·(∂f/∂x)·v] — and folds β into the
    Jacobian coefficient (J ≈ I − dt·(dt+β)·M⁻¹·∂f/∂x, the exact Jacobian
    minus the second-order β·dt·∂²f/∂x²·v curvature term; the line search
    owns global convergence as usual).  In decoupled mode the damping
    operator is the decoupled G(K) — consistent with the semi-implicit
    path; in exact mode it is the exact HVP.

    ``theta`` (generalized-midpoint extension, SimConfig.newton_theta)
    evaluates the elastic force at the θ-weighted position
    x_θ(v) = (1−θ)·xₙ + θ·x_{n+1} = xₙ + θ·dt·((1−θ)·vₙ + θ·v), where
    x_{n+1} = xₙ + dt·((1−θ)vₙ + θv) is the position update the caller must
    apply (sim.substep does, via advect_implicit_step's θ weighting).
    θ = 1 is backward Euler (exactly this function's historical behavior —
    the θ = 1 code path is unchanged); θ = 1/2 the IMPLICIT MIDPOINT rule:
    second-order, symplectic, energy-conserving for free elastic vibration
    (tests/test_midpoint.py).  The Jacobian coefficient becomes
    dt·(θ²·dt + β), threaded through every branch via
    β_eff = β − (1−θ²)·dt (same dt·(dt+β_eff) arithmetic, so the decoupled
    operator / diagonal-block / coarse-space code paths need no changes).
    Damping stays backward Euler on v (dissipation term; conservation at
    β = 0 is unaffected).
    """
    if hessian_mode not in ("exact", "decoupled"):
        raise ValueError(
            f"newton_hessian must be 'exact' or 'decoupled', "
            f"got {hessian_mode!r}"
        )
    from fem_tpu.solvers.multilevel import parse_two_level_precond

    use_pcg = cg_precond == "block_jacobi"
    use_two_level, tl_smoother, tl_degree = parse_two_level_precond(
        cg_precond
    )
    if (use_pcg or use_two_level) and hessian_mode != "decoupled":
        raise ValueError(
            f"integrator='newton' with cg_precond={cg_precond!r} requires "
            "newton_hessian='decoupled' (the exact-HVP mode assembles no "
            "K blocks; use cg_precond='none' there)"
        )
    if use_two_level and obj.agg_ids is None:
        raise ValueError(
            "cg_precond='two_level' needs the coarse space attached at "
            "build time (models/state.build_object)"
        )
    # θ-scheme: every Jacobian coefficient dt·(dt+β) becomes dt·(θ²·dt+β),
    # which is dt·(dt+β_eff) with β_eff = β − (1−θ²)·dt — exactly β at θ=1.
    beta_eff = beta - (1.0 - theta * theta) * dt
    inv_m = 1.0 / obj.mass[:, None]
    free = obj.free_mask  # (N, 1) or None
    held = None if free is None else 1.0 - free
    v_n = state.vel
    # θ < 1 position weighting uses the PHYSICAL start-of-substep velocity:
    # with an external force the caller folds dt·f_ext/m into state.vel (an
    # algebraic rhs trick, not a velocity the body ever had), and the folded
    # value must not enter the (1−θ)·v_n force-evaluation position — the
    # realized trajectory (advect_implicit_step) uses the unfolded one
    # (ADVICE r4 #1).  The residual's (v − v_n) difference term DOES use
    # the folded v_n; that is where the external force enters the solve.
    v_n_pos = v_n if v_n_pos is None else v_n_pos
    x_n = state.pos
    decoupled = hessian_mode == "decoupled"

    def project(r: jnp.ndarray) -> jnp.ndarray:
        return r if free is None else free * r

    def force_exact(pos: jnp.ndarray) -> jnp.ndarray:
        cols = _material_force_columns(obj, pos, robust, layers, axis_name)
        return assemble_for(obj, element_contrib_full(cols), axis_name)

    def eval_at(v: jnp.ndarray):
        """(projected residual, K representation) at iterate ``v``.  In
        decoupled mode ONE element prep yields both."""
        if theta == 1.0:  # keep the backward-Euler path bit-identical
            pos = x_n + dt * v
        else:
            pos = x_n + (theta * dt) * ((1.0 - theta) * v_n_pos + theta * v)
        if decoupled:
            f, krep = _decoupled_prep(obj, pos, axis_name, robust, layers)
            r = (v - v_n) - dt * inv_m * f
            if beta != 0.0:
                gk = _decoupled_minv_gk(obj, krep, axis_name)
                r = r - dt * beta * gk(v)
        else:
            f, krep = force_exact(pos), jnp.zeros((0,), jnp.float32)
            if beta != 0.0:
                _, df_v = jax.jvp(force_exact, (pos,), (v,))
                f = f + beta * df_v
            r = (v - v_n) - dt * inv_m * f
        return project(r), krep

    def _diag_from_krep(krep: jnp.ndarray) -> jnp.ndarray:
        """Per-particle diagonal blocks of the decoupled Jacobian from the
        stored K blocks (block-Jacobi PCG inner solves)."""
        return diagonal_blocks_from(
            obj.element_indices, krep, obj.mass, dt, obj.particle_cnt,
            axis_name, beta_eff,
        )

    def res_norm(r: jnp.ndarray) -> jnp.ndarray:
        m = jnp.max(jnp.abs(r))
        return jnp.where(jnp.isnan(m), jnp.inf, m)

    # Initial iterate: v_n on free DOFs, the prescribed velocity on pins
    # (inhomogeneous Dirichlet — same contract as the projected CG solve,
    # solvers/implicit._cg_solve_dispatch).
    if free is None:
        v0 = v_n
    elif obj.pin_vel is not None:
        v0 = free * v_n + held * obj.pin_vel
    else:
        v0 = free * v_n

    def body(carry):
        v, r, krep, _, it, cg_total, fails = carry

        if decoupled:
            base_op = make_system_apply(obj, krep, dt, axis_name, beta_eff)
        else:
            if theta == 1.0:
                x_i = x_n + dt * v
            else:
                x_i = x_n + (theta * dt) * ((1.0 - theta) * v_n_pos + theta * v)
            coeff = dt * (theta * theta * dt + beta)

            def base_op(w: jnp.ndarray) -> jnp.ndarray:
                _, df = jax.jvp(force_exact, (x_i,), (w,))
                return w - coeff * inv_m * df

        if free is None:
            op = base_op
        else:

            def op(w):
                return free * base_op(free * w) + held * w

        rr = jnp.sum(r * r)
        # Inexact Newton: the inner solve needs only a descent direction —
        # a 1e-4 relative drop in rᵀr (1% in ‖r‖) per Newton step is the
        # standard forcing term; the line search + outer tolerance own
        # global convergence.  A 1e-8 relative tol was measured to over-
        # solve by ~20× in CG iterations for identical trajectories.
        # Absolute floor: never iterate below the outer tolerance's scale.
        inner_tol = jnp.maximum(1e-4 * rr, jnp.float32(tol * tol))
        if use_two_level:
            # Coarse-space additive-Schwarz PCG (solvers/multilevel.py)
            # with the preconditioner FROZEN at the substep's initial
            # iterate (tl_setup, built once below) — quality only; each
            # inner iteration still applies the CURRENT iterate's exact
            # decoupled operator and accepts on its residual.
            from fem_tpu.solvers.multilevel import two_level_pcg

            sol = two_level_pcg(
                op, None, obj.mass, None, None, -r,
                jnp.zeros_like(r), max_iter=cg_iters, tol=inner_tol,
                free_mask=free, setup=tl_setup,
                smoother=tl_smoother, cheb_degree=tl_degree,
            )
        elif use_pcg:
            diag = _diag_from_krep(krep)
            if free is not None:
                eye = jnp.eye(obj.dim, dtype=diag.dtype)[None]
                f3 = free[..., None]
                diag = f3 * diag + (1.0 - f3) * eye
            sol = preconditioned_conjugate_gradient(
                op, diag, obj.mass, -r, jnp.zeros_like(r),
                max_iter=cg_iters, tol=inner_tol,
            )
        else:
            sol = conjugate_gradient(
                op, -r, jnp.zeros_like(r), max_iter=cg_iters, tol=inner_tol,
            )
        delta = project(sol.x)
        r0n = res_norm(r)
        # Sequential backtracking on ‖r‖∞ (NaN-safe: inversion under plain
        # NH reads +inf and is rejected).
        r1, k1 = eval_at(v + delta)

        def ls_cond(c):
            _, rn, _, _, k = c
            return (rn >= r0n) & (k < n_backtrack)

        def ls_body(c):
            t, _, _, _, k = c
            t2 = 0.5 * t
            r_c, k_c = eval_at(v + t2 * delta)
            return (t2, res_norm(r_c), r_c, k_c, k + 1)

        t, rn, r_new, k_new, _ = jax.lax.while_loop(
            ls_cond, ls_body,
            (jnp.float32(1.0), res_norm(r1), r1, k1, jnp.int32(1)),
        )
        any_ok = rn < r0n
        v_out = jnp.where(any_ok, v + t * delta, v)
        r_out = jnp.where(any_ok, r_new, r)
        krep_out = jnp.where(any_ok, k_new, krep)
        gn = jnp.where(any_ok, rn, r0n)
        fails_new = jnp.where(any_ok, jnp.int32(0), fails + 1)
        return (
            v_out, r_out, krep_out, gn, it + 1,
            cg_total + sol.iterations, fails_new,
        )

    def cond(carry):
        _, _, _, gn, it, _, fails = carry
        return (it < max_newton) & (gn > tol) & (fails < 3)

    r0, krep0 = eval_at(v0)
    tl_setup = None
    if use_two_level:
        # Build the two-level preconditioner ONCE per substep from the
        # initial iterate's decoupled blocks (one coarse assembly + one
        # Cholesky, hoisted out of the Newton loop — rebuilding it per
        # iterate would cost more than the whole plain solve).
        from fem_tpu.solvers.multilevel import (
            coarse_matrix, make_coarse_space, two_level_setup,
        )

        diag0 = _diag_from_krep(krep0)
        if free is not None:
            eye0 = jnp.eye(obj.dim, dtype=diag0.dtype)[None]
            f30 = free[..., None]
            diag0 = f30 * diag0 + (1.0 - f30) * eye0
        coarse0 = make_coarse_space(obj)
        c_mat0 = coarse_matrix(
            coarse0, obj, krep0, dt, beta_eff, free, obj.element_indices,
            axis_name,
        )
        base_op0 = make_system_apply(obj, krep0, dt, axis_name, beta_eff)
        if free is None:
            op0 = base_op0
        else:
            def op0(w):
                return free * base_op0(free * w) + held * w

        # operator=op0 hoists the smoother-damping power iteration here
        # too — the whole preconditioner (blocks, coarse factor, ω) costs
        # one assembly + one Cholesky + 12 applies per SUBSTEP.
        tl_setup = two_level_setup(
            diag0, obj.mass, coarse0, c_mat0, free, operator=op0
        )
    carry0 = (
        v0, r0, krep0, res_norm(r0), jnp.int32(0), jnp.int32(0),
        jnp.int32(0),
    )
    v, _, _, gn, _, cg_total, _ = jax.lax.while_loop(cond, body, carry0)
    return state.replace(vel=v), ImplicitAux(cg_total, gn * gn)
