# coding=utf-8
"""Dense backend for the implicit solve (small/medium meshes).

The matrix-free operator (solvers/implicit.py) is O(E) per application but is
built from gathers, small einsums and segment sums — each application costs
several kernel launches and irregular memory traffic.  For meshes whose dense
system fits in device memory (N·d ≲ a few thousand), the alternative is to
*materialize* A = I − dt²M⁻¹G(K) once per substep with one scatter, and run
every CG iteration as a single dense (N·d, N·d) matvec — turning the
latency-bound iteration into one matrix-vector product.

This is still the reference's exact operator (same K blocks, same scatter
pattern as solver/implicit.py:114-194) — only the execution strategy differs.
The normal-equations mode materializes AᵀA once (one matrix product), after which
each reference-CG iteration is a single matvec instead of the matrix-free
double apply.

Backend selection: dense is explicit opt-in via ``solver_backend="dense"``
(fem_tpu/strategy.uses_dense_solver): at the reference's absolute CG
tolerance the solve converges in a handful of iterations, so the O(E)
matrix-free operator is the default.  Which side wins on the GPU at which
size has not been measured.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from fem_tpu.models.state import FemObject, SimState
from fem_tpu.ops.element import hessian_blocks
from fem_tpu.solvers.implicit import (
    ImplicitAux,
    conjugate_gradient,
    implicit_rhs,
    jacobi_solve,
    jacobi_solve_serial,
)
from fem_tpu.utils.config import CONJUGATE_GRADIENT_METHOD, JACOBI_METHOD

def assemble_dense_system(
    obj: FemObject, K: jnp.ndarray, dt: float, axis_name: str | None = None,
    beta: float = 0.0,
) -> jnp.ndarray:
    """Materialize A (N·d, N·d) from the per-element blocks K_e with one
    segment-sum scatter over (row, col) particle pairs.

    Scatter pattern (reference solver/implicit.py:149-181, see
    ops/element.hessian_blocks): for each element with vertices v_0..v_d,
    blocks +K at (v_i, v_i), −K at (v_i, v_0) and (v_0, v_i), and +d·K at
    (v_0, v_0).
    """
    d, n = obj.dim, obj.particle_cnt
    e = K.shape[0]
    idx = obj.element_indices  # (E, d+1)
    v0 = idx[:, 0:1]  # (E, 1)
    vi = idx[:, 1:]  # (E, d)

    # (E, 3d+1) rows/cols/signs: [(vi,vi,+1)]*d, [(vi,v0,-1)]*d,
    # [(v0,vi,-1)]*d, [(v0,v0,+d)].
    rows = jnp.concatenate([vi, vi, jnp.tile(v0, (1, d)), v0], axis=1)
    cols = jnp.concatenate([vi, jnp.tile(v0, (1, d)), vi, v0], axis=1)
    signs = jnp.concatenate(
        [
            jnp.ones((e, d)),
            -jnp.ones((e, d)),
            -jnp.ones((e, d)),
            jnp.full((e, 1), float(d)),
        ],
        axis=1,
    ).astype(K.dtype)

    contrib = signs[..., None] * K.reshape(e, 1, d * d)  # (E, 3d+1, d*d)
    flat_ids = (rows * n + cols).reshape(-1)
    blocks = jax.ops.segment_sum(
        contrib.reshape(-1, d * d), flat_ids, num_segments=n * n
    ).reshape(n, n, d, d)
    if axis_name is not None:  # per-shard element slices → full K grid
        blocks = jax.lax.psum(blocks, axis_name)

    from fem_tpu.solvers.implicit import system_coeff

    a = -system_coeff(dt, beta) * blocks / obj.mass[:, None, None, None]
    eye_blocks = jnp.eye(d, dtype=K.dtype)[None, None] * jnp.eye(
        n, dtype=K.dtype
    )[:, :, None, None]
    a = a + eye_blocks
    return a.transpose(0, 2, 1, 3).reshape(n * d, n * d)


def _matvec(a: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    return jnp.dot(a, x, precision=jax.lax.Precision.HIGHEST)


def implicit_velocity_solve_dense(
    obj: FemObject,
    state: SimState,
    dt: float,
    method: int,
    preconditioned: int,
    robust: bool = False,
    jacobi_sweep: str = "serial",
) -> Tuple[SimState, ImplicitAux]:
    """Dense-backend counterpart of
    :func:`fem_tpu.solvers.implicit.implicit_velocity_solve` — identical
    solver semantics, dense execution."""
    n, d = obj.particle_cnt, obj.dim
    K = hessian_blocks(
        state.pos, obj.element_indices, obj.ref_inv, obj.volume,
        obj.mu, obj.s_lambda, robust, obj.material,
    )
    A = assemble_dense_system(obj, K, dt, beta=obj.damping_beta)
    b = implicit_rhs(obj, state, dt, robust=robust).reshape(-1)

    if method == JACOBI_METHOD:
        if jacobi_sweep == "serial":
            res = jacobi_solve_serial(A, b.reshape(n, d), state.jacobi_past_x)
        else:
            diag = jnp.diagonal(A).reshape(n, d)
            diag_blocks = jax.vmap(jnp.diag)(diag)  # (N, d, d) diag entries
            op = lambda v: _matvec(A, v.reshape(-1)).reshape(n, d)
            res = jacobi_solve(
                op, diag_blocks, b.reshape(n, d), state.jacobi_past_x
            )
        new_state = state.replace(vel=res.x, jacobi_past_x=res.past_x)
        return new_state, ImplicitAux(res.iterations, res.error)

    if method == CONJUGATE_GRADIENT_METHOD:
        if preconditioned == 1:
            # Double matvec per application: materializing AᵀA costs ~N·d
            # matvecs (1926³ flops at spot size) and only pays off past ~1000
            # CG iterations — the reference caps at 500 (implicit.py:337).
            op = lambda v: _matvec(A.T, _matvec(A, v))
            rhs = _matvec(A.T, b)
        else:
            op = lambda v: _matvec(A, v)
            rhs = b
        res = conjugate_gradient(op, rhs, x0=b)
        return (
            state.replace(vel=res.x.reshape(n, d)),
            ImplicitAux(res.iterations, res.residual),
        )

    raise ValueError(f"unknown implicit method {method}")
