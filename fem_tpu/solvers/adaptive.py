# coding=utf-8
"""Adaptive-dt κ-guard (extension; VERDICT r3 #4 — no reference counterpart).

The reference integrates at a fixed config dt with no stability monitor (its
only guard is the Hessian logJ clamp, /root/reference solver/implicit.py:131)
— at scale that silently NaNs: the decoupled-Hessian integrator blows up when
κ = dt²·‖K‖/m approaches 1 as element size shrinks or deep squash stiffens
elements (68k tets at dt=5e-4 NaN ~0.2 s of simulated time after impact;
the reference's own spot.obj at its default dt=5e-4 NaNs at t≈5 simulated
s).  ``adaptive_dt=true`` monitors exactly that indicator each
substep and, when it crosses threshold, splits the substep into 2/4/8
state-consistent inner steps at dt/n (κ ∝ dt², so halving dt quarters κ).
Off by default: guarded trajectories deviate from fixed-dt parity the moment
a split triggers (they are the trajectories that otherwise NaN).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from fem_tpu.models.state import FemObject
from fem_tpu.ops.element import hessian_blocks
from fem_tpu.solvers.implicit import diagonal_blocks_from

# Split ladder: dt, dt/2, dt/4, dt/8.
_LEVELS = (1, 2, 4, 8)


def kappa_estimate(
    obj: FemObject,
    pos: jnp.ndarray,
    dt: float,
    robust: bool = False,
    axis_name: str | None = None,
) -> jnp.ndarray:
    """The stability indicator κ = max_i dt²·‖(diag K)_i‖_F / m_i — the
    Frobenius size of the largest assembled diagonal block of dt²·M⁻¹K,
    i.e. ‖A_ii − I‖_F of the implicit system.  κ ≪ 1: the fixed-dt regime
    is comfortable; κ → 1: the integrator is at its blow-up edge.  One
    element chain + one O(E) assembly —
    about the cost of a single operator apply."""
    K = hessian_blocks(
        pos, obj.element_indices, obj.ref_inv, obj.volume, obj.mu,
        obj.s_lambda, robust, obj.material,
    )
    diag_a = diagonal_blocks_from(
        obj.element_indices, K, obj.mass, dt, obj.particle_cnt, axis_name
    )
    dev = diag_a - jnp.eye(obj.dim, dtype=diag_a.dtype)[None]
    return jnp.sqrt(jnp.max(jnp.sum(dev * dev, axis=(1, 2))))


def split_level(kappa: jnp.ndarray, threshold: float) -> jnp.ndarray:
    """Branch index into ``_LEVELS`` such that κ/(n²) ≤ threshold (κ scales
    with dt²): 0 when κ ≤ θ, else ceil(log₄(κ/θ)) clamped to the ladder."""
    ratio = jnp.maximum(kappa / threshold, 1e-30)
    lvl = jnp.ceil(0.5 * jnp.log2(ratio))
    return jnp.clip(lvl.astype(jnp.int32), 0, len(_LEVELS) - 1)


def adaptive_substep(substep_at_dt, obj, state, *, dt, threshold,
                     robust=False, axis_name=None):
    """One guarded outer substep: measure κ at the current positions, pick
    the split level, run n inner substeps at dt/n under ``lax.switch``.

    ``substep_at_dt(dt_eff, state) -> (state, StepAux)`` must be closed over
    everything else (method dispatch, obstacles).  Aux aggregation: solver
    iterations summed over inner steps (total work), residual of the last
    inner step."""
    kappa = kappa_estimate(obj, state.pos, dt, robust, axis_name)
    idx = split_level(kappa, threshold)

    def make_branch(n):
        def branch(s):
            def body(carry, _):
                st, it_acc = carry
                st, aux = substep_at_dt(dt / n, st)
                return (st, it_acc + aux.solver_iterations), aux.solver_residual

            (s2, iters), res = jax.lax.scan(
                body, (s, jnp.int32(0)), None, length=n
            )
            return s2, iters, res[-1]

        return branch

    return jax.lax.switch(
        idx, [make_branch(n) for n in _LEVELS], state
    )
