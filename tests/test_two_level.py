# coding=utf-8
"""Two-level coarse-space preconditioner (``cg_precond="two_level"``,
solvers/multilevel.py) — the real preconditioner for the large-dt regime
where the implicit operator's condition number grows as dt²."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fem_tpu.models.state import Obstacles
from fem_tpu.ops.element import hessian_blocks
from fem_tpu.sim import make_substep_fn
from fem_tpu.solvers.implicit import (
    conjugate_gradient,
    diagonal_blocks,
    implicit_velocity_solve,
    make_system_apply,
)
from fem_tpu.solvers.multilevel import (
    build_aggregates,
    coarse_matrix,
    make_coarse_space,
    n_rigid_modes,
    two_level_pcg,
)
from fem_tpu.utils.config import SimConfig
from tests.utils import make_2d_object, make_3d_object


def _perturbed_system(subdivisions=20, dt=3.2e-2, seed=0, **mat):
    _, obj, state = make_2d_object(subdivisions=subdivisions, **mat)
    rng = np.random.default_rng(seed)
    pos = state.pos + 0.001 * jnp.asarray(
        rng.standard_normal(state.pos.shape), jnp.float32
    )
    K = hessian_blocks(
        pos, obj.element_indices, obj.ref_inv, obj.volume, obj.mu,
        obj.s_lambda,
    )
    b = jnp.asarray(
        rng.standard_normal(state.pos.shape), jnp.float32
    )
    return obj, K, b, dt


def test_aggregates_partition_and_rigid_basis():
    rng = np.random.default_rng(0)
    pos = rng.random((500, 3)).astype(np.float32)
    agg, basis = build_aggregates(pos, target_size=40)
    assert agg.min() == 0 and agg.max() + 1 == len(np.unique(agg))
    sizes = np.bincount(agg)
    assert sizes.min() >= 30 and sizes.max() <= 50  # balanced
    # Rigid columns: applying a coarse translation moves every particle of
    # the aggregate identically; a rotation column is orthogonal to it.
    g = 0
    sel = agg == g
    t_col = basis[sel, :, 0]  # x-translation values
    assert np.allclose(t_col[:, 0], t_col[0, 0])
    assert np.allclose(t_col[:, 1:], 0.0)


def test_coarse_matrix_matches_dense():
    from fem_tpu.solvers.dense import assemble_dense_system

    obj, K, _, dt = _perturbed_system(subdivisions=8)
    coarse = make_coarse_space(obj)
    C = np.asarray(coarse_matrix(coarse, obj, K, dt), np.float64)
    n, nrb = obj.particle_cnt, n_rigid_modes(2)
    A = np.asarray(assemble_dense_system(obj, K, dt), np.float64)
    m = np.asarray(obj.mass, np.float64)
    sq = np.repeat(np.sqrt(m), 2)
    a_sym = 0.5 * ((sq[:, None] * A) / sq[None, :]
                   + ((sq[:, None] * A) / sq[None, :]).T)
    basis = np.asarray(coarse.basis)
    agg = np.asarray(coarse.agg_ids)
    G = coarse.num_aggregates
    R = np.zeros((n * 2, G * nrb))
    for p in range(n):
        R[2 * p:2 * p + 2, agg[p] * nrb:(agg[p] + 1) * nrb] = basis[p]
    rt = sq[:, None] * R
    c_direct = rt.T @ a_sym @ rt
    ridge = np.abs(np.diag(C - c_direct)).max()  # the deliberate ridge
    np.testing.assert_allclose(
        C, c_direct + ridge * np.eye(C.shape[0]), rtol=2e-4, atol=2e-4
    )


def test_iteration_advantage_at_large_dt():
    obj, K, b, dt = _perturbed_system(dt=3.2e-2)
    apply_a = make_system_apply(obj, K, dt)
    res_plain = conjugate_gradient(apply_a, b, x0=b)
    coarse = make_coarse_space(obj)
    c_mat = coarse_matrix(coarse, obj, K, dt)
    res_2l = two_level_pcg(
        apply_a, diagonal_blocks(obj, K, dt), obj.mass, coarse, c_mat,
        b, x0=b,
    )
    assert int(res_2l.iterations) * 3 < int(res_plain.iterations)
    assert float(res_2l.residual) <= 1e-5
    # Same accepted-solution contract (absolute tolerance on b − Ax).
    np.testing.assert_allclose(
        np.asarray(res_plain.x), np.asarray(res_2l.x), atol=5e-4
    )


def test_substep_two_level_matches_plain():
    """At the reference-stable dt both solves accept interchangeable
    solutions (same absolute-tolerance contract); the preconditioner must
    never be WORSE in iterations there."""
    cfg_kwargs = dict(
        dim=2, delta_time=5e-4, sim_count=5, auto_diff=False,
        use_explicit_method=False, implicit_method=1, preconditioned=0,
        g_dir=(0.0, -1.0), blocks=(),
    )
    outs = {}
    for precond in ("none", "two_level"):
        cfg = SimConfig(cg_precond=precond, **cfg_kwargs)
        _, obj, state = make_2d_object(subdivisions=10)
        obstacles = Obstacles.from_configs((), 2)
        fn = make_substep_fn(obj, cfg)
        iters = 0
        for _ in range(10):
            state, aux = fn(state, obstacles)
            iters += int(aux.solver_iterations)
        outs[precond] = (state, iters)
    np.testing.assert_allclose(
        np.asarray(outs["none"][0].pos),
        np.asarray(outs["two_level"][0].pos), atol=2e-4,
    )
    assert outs["two_level"][1] <= outs["none"][1] + 2


def test_two_level_with_pins():
    cfg = SimConfig(
        dim=2, delta_time=8e-3, sim_count=5, auto_diff=False,
        use_explicit_method=False, implicit_method=1, preconditioned=0,
        g_dir=(0.0, -1.0), blocks=(), cg_precond="two_level",
        # Large dt needs the true backward-Euler integrator (semi-implicit
        # is unstable past κ ≈ 1 regardless of the linear solver).
        integrator="newton", newton_hessian="decoupled",
        newton_cg_iters=400,
    )
    _, obj, state = make_2d_object(
        subdivisions=8,
        pin_boxes=(((0.39, 0.99), (0.62, 1.01)),),
        center=(0.4, 0.8),
    )
    assert obj.free_mask is not None
    obstacles = Obstacles.from_configs((), 2)
    fn = make_substep_fn(obj, cfg)
    pinned = np.asarray(obj.free_mask)[:, 0] == 0.0
    p0 = np.asarray(state.pos)[pinned]
    for _ in range(20):
        state, _ = fn(state, obstacles)
    p = np.asarray(state.pos)
    assert np.all(np.isfinite(p))
    np.testing.assert_array_equal(p[pinned], p0)  # pins held exactly
    # Free part sagged under gravity.
    assert p[~pinned, 1].min() < np.asarray(obj.rest_pos)[~pinned, 1].min()


def test_three_d_path():
    """3D grid mesh: the coarse matrix assembles from 3D element blocks;
    the two-level PCG must agree with plain CG in fewer iterations."""
    cfg_kwargs = dict(
        dim=3, delta_time=4e-3, sim_count=5, auto_diff=False,
        use_explicit_method=False, implicit_method=1, preconditioned=0,
        g_dir=(0.0, -1.0, 0.0), blocks=(),
    )
    outs = {}
    for precond in ("none", "two_level"):
        cfg = SimConfig(cg_precond=precond, **cfg_kwargs)
        _, obj, state = make_3d_object(subdivisions=4)
        obstacles = Obstacles.from_configs((), 3)
        fn = make_substep_fn(obj, cfg)
        iters = 0
        for _ in range(6):
            state, aux = fn(state, obstacles)
            iters += int(aux.solver_iterations)
        outs[precond] = (state, iters)
    np.testing.assert_allclose(
        np.asarray(outs["none"][0].pos),
        np.asarray(outs["two_level"][0].pos), atol=5e-4,
    )
    assert outs["two_level"][1] <= outs["none"][1]


def test_newton_two_level_inner_solves():
    """A hanging strip under gravity at 32× the reference dt: real elastic
    residuals every substep; the coarse-space PCG must cut the inner
    iteration count clearly and land on the same trajectory."""
    base = dict(
        dim=2, delta_time=1.6e-2, sim_count=4, auto_diff=False,
        use_explicit_method=False, implicit_method=1, preconditioned=0,
        g_dir=(0.0, -1.0), blocks=(), integrator="newton",
        newton_hessian="decoupled", newton_cg_iters=400,
    )
    pin = (((0.39, 0.99), (0.62, 1.01)),)
    outs = {}
    for precond in ("none", "two_level"):
        cfg = SimConfig(cg_precond=precond, **base)
        _, obj, state = make_2d_object(
            subdivisions=12, pin_boxes=pin, center=(0.4, 0.8)
        )
        obstacles = Obstacles.from_configs((), 2)
        fn = make_substep_fn(obj, cfg)
        iters = 0
        for _ in range(8):
            state, aux = fn(state, obstacles)
            iters += int(aux.solver_iterations)
        outs[precond] = (state, iters)
    assert outs["none"][1] > 50  # the comparison is non-trivial
    # Both are valid inexact-Newton trajectories (1e-4 relative forcing);
    # on a swinging strip the accepted-solution slack amplifies, so the
    # bound is loose — the tight agreement check lives in
    # test_substep_two_level_matches_plain / the raw-solver tests.
    np.testing.assert_allclose(
        np.asarray(outs["none"][0].pos),
        np.asarray(outs["two_level"][0].pos), atol=1.5e-2,
    )
    # Large dt: the inner iteration count must drop clearly.
    assert outs["two_level"][1] < 0.7 * outs["none"][1]


def test_sharded_two_level_matches_single_device():
    from fem_tpu.parallel.sharding import (
        make_element_mesh, make_sharded_substep_fn,
    )

    cfg = SimConfig(
        dim=2, delta_time=8e-3, sim_count=3, auto_diff=False,
        use_explicit_method=False, implicit_method=1, preconditioned=0,
        g_dir=(0.0, -1.0), blocks=(), cg_precond="two_level",
    )
    _, obj, state = make_2d_object(subdivisions=8)
    obstacles = Obstacles.from_configs((), 2)
    single = make_substep_fn(obj, cfg)
    mesh = make_element_mesh(4)
    sharded = make_sharded_substep_fn(obj, cfg, mesh)
    s1, s8 = state, state
    for _ in range(5):
        s1, _ = single(s1, obstacles)
        s8, _ = sharded(s8, obstacles)
    np.testing.assert_allclose(
        np.asarray(s1.pos), np.asarray(s8.pos), atol=2e-5
    )


def test_exact_jvp_rejects_two_level():
    _, obj, state = make_2d_object(subdivisions=4)
    with pytest.raises(ValueError, match="two_level"):
        implicit_velocity_solve(
            obj, state, 1e-3, 1, 0, hessian="exact_jvp",
            cg_precond="two_level",
        )


def test_static_two_level_matches_plain():
    """Quasi-statics (the mass-free elliptic regime the coarse space owns):
    same equilibrium, and the inner-solve advantage measured directly —
    the standalone operator probe showed 306→77 iters at subdivisions=40
    (gap GROWS with resolution: plain scales ~L/h, two-level nearly flat)."""
    from fem_tpu.solvers.static import solve_static

    _, obj, state = make_2d_object(
        subdivisions=16, center=(0.4, 0.6),
        pin_boxes=(((0.39, 0.795), (0.62, 0.805)),),
    )
    res_p = solve_static(
        obj, state.pos, g_dir=(0.0, -1.0), cg_precond="none",
        cg_iters=1500,
    )
    res_2 = solve_static(
        obj, state.pos, g_dir=(0.0, -1.0), cg_precond="two_level",
        cg_iters=1500,
    )
    np.testing.assert_allclose(
        np.asarray(res_p.pos), np.asarray(res_2.pos), atol=2e-4
    )
    assert float(res_2.grad_norm) <= 2.0 * float(res_p.grad_norm)


def test_parse_two_level_precond():
    from fem_tpu.solvers.multilevel import parse_two_level_precond

    assert parse_two_level_precond("two_level") == (True, "jacobi", 0)
    assert parse_two_level_precond("two_level_cheb") == (
        True, "chebyshev", 3,
    )
    assert parse_two_level_precond("two_level_cheb2") == (
        True, "chebyshev", 2,
    )
    assert parse_two_level_precond("none") == (False, "", 0)
    assert parse_two_level_precond("block_jacobi") == (False, "", 0)
    with pytest.raises(ValueError, match="degree"):
        parse_two_level_precond("two_level_cheb9")


def test_chebyshev_smoother_iteration_cut():
    """The Chebyshev sweep targets the whole [λmax/α, λmax] band of D⁻¹Ã,
    so at large dt it must cut iterations vs BOTH plain CG and the
    single-sweep Jacobi V-cycle, while accepting the same solution
    (absolute-tolerance contract)."""
    obj, K, b, dt = _perturbed_system(dt=3.2e-2)
    apply_a = make_system_apply(obj, K, dt)
    res_plain = conjugate_gradient(apply_a, b, x0=b)
    coarse = make_coarse_space(obj)
    c_mat = coarse_matrix(coarse, obj, K, dt)
    diag = diagonal_blocks(obj, K, dt)
    res_jac = two_level_pcg(
        apply_a, diag, obj.mass, coarse, c_mat, b, x0=b,
    )
    res_cheb = two_level_pcg(
        apply_a, diag, obj.mass, coarse, c_mat, b, x0=b,
        smoother="chebyshev", cheb_degree=3,
    )
    assert float(res_cheb.residual) <= 1e-5
    assert int(res_cheb.iterations) < int(res_jac.iterations)
    assert int(res_cheb.iterations) * 5 < int(res_plain.iterations)
    np.testing.assert_allclose(
        np.asarray(res_plain.x), np.asarray(res_cheb.x), atol=5e-4
    )


def test_substep_chebyshev_matches_plain():
    """Full substep routing for cg_precond="two_level_cheb3" (graph
    operator): interchangeable solution at the reference-stable dt."""
    cfg_kwargs = dict(
        dim=2, delta_time=5e-4, sim_count=5, auto_diff=False,
        use_explicit_method=False, implicit_method=1, preconditioned=0,
        g_dir=(0.0, -1.0), blocks=(),
    )
    outs = {}
    for precond in ("none", "two_level_cheb3"):
        cfg = SimConfig(cg_precond=precond, **cfg_kwargs)
        _, obj, state = make_2d_object(subdivisions=10)
        obstacles = Obstacles.from_configs((), 2)
        fn = make_substep_fn(obj, cfg)
        for _ in range(10):
            state, aux = fn(state, obstacles)
        outs[precond] = state
    np.testing.assert_allclose(
        np.asarray(outs["none"].pos),
        np.asarray(outs["two_level_cheb3"].pos), atol=2e-4,
    )


def test_newton_chebyshev_inner_solves():
    """Newton + two_level_cheb reaches the same root as Newton + plain CG
    at a dt far past the semi-implicit κ≈1 boundary."""
    cfg_kwargs = dict(
        dim=2, delta_time=8e-3, sim_count=5, auto_diff=False,
        use_explicit_method=False, implicit_method=1, preconditioned=0,
        g_dir=(0.0, -1.0), blocks=(), integrator="newton",
        newton_hessian="decoupled", newton_cg_iters=400,
    )
    outs = {}
    for precond in ("none", "two_level_cheb3"):
        cfg = SimConfig(cg_precond=precond, **cfg_kwargs)
        _, obj, state = make_2d_object(subdivisions=8)
        obstacles = Obstacles.from_configs((), 2)
        fn = make_substep_fn(obj, cfg)
        for _ in range(10):
            state, _ = fn(state, obstacles)
        outs[precond] = np.asarray(state.pos)
    assert np.isfinite(outs["two_level_cheb3"]).all()
    np.testing.assert_allclose(
        outs["none"], outs["two_level_cheb3"], atol=5e-4,
    )
