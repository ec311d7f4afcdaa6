# coding=utf-8
"""Block-Jacobi PCG extension (``cg_precond``, round-4 VERDICT r3 #1).

The reference's only "preconditioner" is normal-equations CG (AᵀAx = Aᵀb,
/root/reference solver/implicit.py:289-299) which doubles operator applies;
``cg_precond="block_jacobi"`` is an actual preconditioner: M⁻¹ = inverted
per-particle d×d diagonal blocks of A, 1 apply/iteration, terminating on the
reference's absolute rᵀr ≤ 1e-5 so accepted solutions are interchangeable."""

import jax.numpy as jnp
import numpy as np
import pytest

from fem_tpu.ops.element import hessian_blocks
from fem_tpu.sim import make_frame_fn, make_substep_fn
from fem_tpu.solvers.implicit import (
    conjugate_gradient,
    diagonal_blocks,
    diagonal_blocks_from,
    make_system_apply,
    preconditioned_conjugate_gradient,
)
from fem_tpu.utils.config import SimConfig
from tests.utils import (
    attach_edge_matrix,
    default_obstacles,
    default_sim_config_3d,
    make_2d_object,
    make_3d_object,
)


def _system(kappa_target=0.9, subdivisions=6, hetero_mass=False, b_scale=1.0):
    """A small system in the PHYSICAL κ < 1 regime: dt is calibrated so the
    largest ‖A_ii − I‖_F hits ``kappa_target`` (κ ≥ 1 makes the decoupled
    system indefinite — the measured integrator blow-up regime, where NO CG
    variant converges).  ``hetero_mass``
    randomizes masses ×[0.05, 20] — the case where the diagonal varies and
    block-Jacobi has something to equilibrate."""
    _, obj, state = make_2d_object(subdivisions=subdivisions)
    rng = np.random.default_rng(0)
    pos = state.pos + 0.002 * jnp.asarray(
        rng.standard_normal(state.pos.shape), jnp.float32
    )
    if hetero_mass:
        obj = obj.replace(
            mass=jnp.asarray(
                np.asarray(obj.mass)
                * rng.uniform(0.05, 20.0, obj.particle_cnt).astype(np.float32)
            )
        )
    K = hessian_blocks(
        pos, obj.element_indices, obj.ref_inv, obj.volume, obj.mu,
        obj.s_lambda,
    )
    dev1 = diagonal_blocks(obj, K, 1.0) - jnp.eye(2)[None]
    dev0 = float(jnp.max(jnp.sqrt(jnp.sum(dev1 * dev1, axis=(1, 2)))))
    dt = float(np.sqrt(kappa_target / dev0))
    apply_a = make_system_apply(obj, K, dt)
    b = b_scale * jnp.asarray(
        rng.standard_normal(state.pos.shape), jnp.float32
    )
    diag = diagonal_blocks(obj, K, dt)
    return apply_a, b, diag, obj, K, dt


def test_pcg_reaches_reference_tolerance():
    apply_a, b, diag, obj, _, _ = _system()
    res = preconditioned_conjugate_gradient(
        apply_a, diag, obj.mass, b, x0=b
    )
    r = b - apply_a(res.x)
    assert float(jnp.sum(r * r)) <= 1e-5 * 1.01
    # And the solution agrees with plain CG's accepted solution.
    plain = conjugate_gradient(apply_a, b, x0=b)
    np.testing.assert_allclose(
        np.asarray(res.x), np.asarray(plain.x), rtol=0, atol=5e-3
    )


@pytest.mark.parametrize("b_scale", [1.0, 10.0])
def test_pcg_never_loses_and_cuts_iterations_hetero(b_scale):
    """The point of the extension: ≤ plain-CG applies always, strictly fewer
    where the diagonal varies (heterogeneous mass); and no stalls — the
    mass-symmetrized Krylov process converges where raw-A PCG was measured
    to stall at 500 iterations."""
    apply_a, b, diag, obj, _, _ = _system(hetero_mass=True, b_scale=b_scale)
    plain = conjugate_gradient(apply_a, b, x0=b)
    pcg = preconditioned_conjugate_gradient(apply_a, diag, obj.mass, b, x0=b)
    r = b - apply_a(pcg.x)
    assert float(jnp.sum(r * r)) <= 1e-5 * 1.01
    assert int(pcg.iterations) <= int(plain.iterations), (
        int(pcg.iterations), int(plain.iterations),
    )
    if b_scale > 1.0:
        assert int(pcg.iterations) < int(plain.iterations)


def test_diagonal_blocks_from_matches_object_form():
    apply_a, b, diag, obj, K, dt = _system()
    diag2 = diagonal_blocks_from(
        obj.element_indices, K, obj.mass, dt, obj.particle_cnt
    )
    scale = float(jnp.max(jnp.abs(diag)))
    np.testing.assert_allclose(
        np.asarray(diag2), np.asarray(diag), rtol=0, atol=1e-6 * scale
    )


def test_diagonal_blocks_match_dense_assembly():
    """The per-particle diagonal blocks PCG inverts are the diagonal d×d
    blocks of the densely assembled reference system (numpy loops,
    models/state.dense_system_matrix)."""
    from fem_tpu.models.state import dense_system_matrix

    _, obj, state = make_2d_object(subdivisions=5)
    rng = np.random.default_rng(3)
    state = state.replace(pos=state.pos + 0.002 * jnp.asarray(
        rng.standard_normal(state.pos.shape), jnp.float32
    ))
    dt = 5e-3
    K = hessian_blocks(
        state.pos, obj.element_indices, obj.ref_inv, obj.volume, obj.mu,
        obj.s_lambda,
    )
    diag = diagonal_blocks(obj, K, dt)
    a = dense_system_matrix(obj, state, dt)
    d, n = obj.dim, obj.particle_cnt
    want = np.stack([a[i * d:(i + 1) * d, i * d:(i + 1) * d]
                     for i in range(n)])
    np.testing.assert_allclose(
        np.asarray(diag), want, rtol=0, atol=1e-5 * np.abs(want).max()
    )


def _cfg(**kw):
    base = dict(
        dim=2,
        delta_time=5e-4,
        sim_count=2,
        use_explicit_method=False,
        auto_diff=False,
        implicit_method=1,
        preconditioned=1,
        g_dir=(0.0, -1.0),
    )
    base.update(kw)
    return SimConfig(**base)


@pytest.mark.parametrize("operator_mode", ["graph", "mxu"])
def test_substep_block_jacobi_close_to_reference(operator_mode):
    """Same physics, different solver route: both satisfy the absolute
    residual tolerance, so velocities agree to solver tolerance."""
    _, obj, state = make_2d_object(subdivisions=4)
    if operator_mode == "mxu":
        obj = attach_edge_matrix(obj)
    state = state.replace(vel=state.vel + 0.3)
    obs = default_obstacles()
    s_ref, _ = make_substep_fn(
        obj, _cfg(operator_mode=operator_mode)
    )(state, obs)
    s_pcg, _ = make_substep_fn(
        obj, _cfg(operator_mode=operator_mode, cg_precond="block_jacobi")
    )(state, obs)
    np.testing.assert_allclose(
        np.asarray(s_pcg.vel), np.asarray(s_ref.vel), rtol=0, atol=5e-3
    )
    assert np.isfinite(np.asarray(s_pcg.pos)).all()


def test_block_jacobi_solves_dense_system():
    """The block-Jacobi PCG solution satisfies the densely assembled
    reference system to the reference's absolute tolerance rᵀr ≤ 1e-5."""
    from fem_tpu.models.state import dense_system_matrix
    from fem_tpu.solvers.implicit import implicit_rhs, implicit_velocity_solve

    _, obj, state = make_2d_object(subdivisions=4)
    state = state.replace(vel=state.vel - 0.2)
    dt = 5e-4
    solved, _ = implicit_velocity_solve(
        obj, state, dt, 1, 1, cg_precond="block_jacobi"
    )
    a = dense_system_matrix(obj, state, dt)
    b = np.asarray(implicit_rhs(obj, state, dt), np.float64).reshape(-1)
    r = b - a @ np.asarray(solved.vel, np.float64).reshape(-1)
    assert float(r @ r) <= 1.5e-5


def test_cg_precond_none_forces_plain_cg():
    """cg_precond='none' must reproduce the preconditioned=0 result exactly
    even when the config says preconditioned=1."""
    _, obj, state = make_2d_object(subdivisions=4)
    state = state.replace(vel=state.vel + 0.1)
    obs = default_obstacles()
    s_plain, aux_plain = make_substep_fn(
        obj, _cfg(preconditioned=0, operator_mode="graph")
    )(state, obs)
    s_none, aux_none = make_substep_fn(
        obj, _cfg(preconditioned=1, operator_mode="graph", cg_precond="none")
    )(state, obs)
    assert (np.asarray(s_none.vel) == np.asarray(s_plain.vel)).all()
    assert int(aux_none.solver_iterations) == int(
        aux_plain.solver_iterations
    )


def test_block_jacobi_with_exact_jvp_raises():
    _, obj, state = make_2d_object(subdivisions=3)
    obs = default_obstacles()
    with pytest.raises(ValueError, match="block_jacobi"):
        make_substep_fn(
            obj, _cfg(hessian="exact_jvp", cg_precond="block_jacobi")
        )(state, obs)


def test_block_jacobi_3d_frame_close_to_reference():
    """A 3D frame under block-Jacobi PCG tracks the reference CG frame to
    solver tolerance."""
    from fem_tpu.models.state import Obstacles

    _, obj, state = make_3d_object(subdivisions=3)
    state = state.replace(vel=state.vel + 0.2)
    obs = Obstacles.from_configs((), 3)
    s_ref, _ = make_frame_fn(obj, default_sim_config_3d(sim_count=4))(
        state, obs
    )
    s_pcg, _ = make_frame_fn(
        obj, default_sim_config_3d(sim_count=4, cg_precond="block_jacobi")
    )(state, obs)
    np.testing.assert_allclose(
        np.asarray(s_pcg.pos), np.asarray(s_ref.pos), rtol=0, atol=1e-5
    )
    assert np.isfinite(np.asarray(s_pcg.vel)).all()
