# coding=utf-8
"""The plain-XLA element chain, operator, assembly and solvers against the
float64 oracle (tests/oracle.py) and dense numpy assembly.

These cases took over the grid of the removed accelerator-kernel tests,
which compared each kernel with the graph path: the graph path itself is
now compared with references that share no code with it, in 2D and 3D.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from fem_tpu.models.state import build_object
from fem_tpu.ops.assembly import (
    assemble_for,
    build_gather_plan,
    element_contrib_full,
    split_two_tier,
)
from fem_tpu.ops.element import (
    explicit_grad_columns,
    hessian_blocks,
    implicit_force_columns,
)
from fem_tpu.solvers.explicit import (
    analytic_energy_gradient,
    autodiff_energy_gradient,
)
from fem_tpu.solvers.implicit import (
    diagonal_blocks,
    implicit_rhs,
    implicit_velocity_solve,
    make_system_apply,
    make_system_apply_t,
)
from fem_tpu.utils.config import ObjectConfig
from tests.oracle import Oracle
from tests.utils import cube_tet_mesh, make_2d_object

DT = 5e-4
DIMS = [2, 3]


def _body(dim, seed=0):
    """(object, deformed state, oracle at the same state): a 2D grid square
    or a Delaunay-meshed cube, squashed and kicked so forces, CG iterations
    and Jacobi sweeps are non-trivial."""
    if dim == 2:
        ocfg, obj, state = make_2d_object(
            subdivisions=3, center=(0.4, 0.5), E=4e4, nu=0.3
        )
    else:
        nodes, f, tets = cube_tet_mesh(spacing=0.45)
        ocfg = ObjectConfig(obj="cube", center=(0.3, 0.45, 0.3), rho=1000.0,
                            E=4e4, nu=0.3, damping=10.0)
        obj, state = build_object(
            ocfg, (nodes * 0.35).astype(np.float32), f, tets
        )
    rng = np.random.default_rng(seed)
    rest = np.asarray(state.pos, np.float64)
    c = rest.mean(0, keepdims=True)
    pos = c + (rest - c) * np.array([1.1, 0.85, 1.05][:dim])
    pos = pos + rng.uniform(-0.004, 0.004, pos.shape)
    vel = rng.uniform(-0.2, 0.2, pos.shape)
    state = state.replace(
        pos=jnp.asarray(pos, jnp.float32), vel=jnp.asarray(vel, jnp.float32)
    )
    oracle = Oracle(rest, np.asarray(obj.element_indices), ocfg.rho,
                    ocfg.mu, ocfg.s_lambda, ocfg.damping)
    oracle.pos = np.asarray(state.pos, np.float64)
    oracle.vel = np.asarray(state.vel, np.float64)
    return obj, state, oracle


def _close(got, want, rel):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(
        np.asarray(got, np.float64), want, rtol=0,
        atol=rel * max(np.abs(want).max(), 1e-30),
    )


def _assembled(obj, cols):
    return assemble_for(obj, element_contrib_full(cols))


# -- element chain ---------------------------------------------------------

@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize(
    "quantity", ["grad_columns", "hessian_blocks", "force_columns"]
)
def test_element_chain_matches_oracle(dim, quantity):
    obj, state, oracle = _body(dim)
    args = (state.pos, obj.element_indices, obj.ref_inv, obj.volume,
            obj.mu, obj.s_lambda)
    got = {
        "grad_columns": lambda: explicit_grad_columns(*args),
        "hessian_blocks": lambda: hessian_blocks(*args),
        "force_columns": lambda: implicit_force_columns(*args, False),
    }[quantity]()
    _close(got, getattr(oracle, quantity)(), 2e-5)


def test_zero_volume_padding_contributes_nothing():
    """Zero-volume copies of element 0 (the sharded path's padding) add
    exactly zero force and stiffness."""
    obj, state, _ = _body(3)
    idx = jnp.concatenate([obj.element_indices, obj.element_indices[:1]])
    ref_inv = jnp.concatenate([obj.ref_inv, obj.ref_inv[:1]])
    vol = jnp.concatenate([obj.volume, jnp.zeros((1,), jnp.float32)])
    args = (state.pos, idx, ref_inv, vol, obj.mu, obj.s_lambda)
    for cols in (explicit_grad_columns(*args), hessian_blocks(*args),
                 implicit_force_columns(*args, False)):
        assert np.all(np.asarray(cols)[-1] == 0.0)


# -- assembly and operator ---------------------------------------------------

@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("method", ["analytic", "autodiff"])
def test_gradient_matches_oracle(dim, method):
    obj, state, oracle = _body(dim, seed=1)
    fn = {"analytic": analytic_energy_gradient,
          "autodiff": autodiff_energy_gradient}[method]
    _close(fn(obj, state.pos), oracle._grad(), 2e-5)


@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("assembly", ["gather", "segment"])
def test_rhs_matches_oracle(dim, assembly):
    """b = v + dt·M⁻¹·f by the gather plan (single device) and by
    segment-sum (the sharded path's form)."""
    obj, state, oracle = _body(dim, seed=2)
    obj = obj.replace(assembly_mode=assembly)
    _, b = oracle._dense_system(DT)
    _close(implicit_rhs(obj, state, DT).reshape(-1), b, 2e-6)


@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("transpose", [False, True], ids=["A", "At"])
def test_operator_matches_oracle_dense_system(dim, transpose):
    obj, state, oracle = _body(dim, seed=3)
    K = hessian_blocks(state.pos, obj.element_indices, obj.ref_inv,
                       obj.volume, obj.mu, obj.s_lambda)
    dt = 5e-3  # large enough that the stiffness term dominates A − I
    a, _ = oracle._dense_system(dt)
    x = np.random.default_rng(4).standard_normal(state.pos.shape)
    make = make_system_apply_t if transpose else make_system_apply
    got = make(obj, K, dt)(jnp.asarray(x, jnp.float32))
    want = (a.T if transpose else a) @ x.reshape(-1)
    _close(np.asarray(got).reshape(-1) - x.reshape(-1),
           want - x.reshape(-1), 2e-5)


@pytest.mark.parametrize("dim", DIMS)
def test_diagonal_blocks_match_oracle_dense_system(dim):
    obj, state, oracle = _body(dim, seed=5)
    K = hessian_blocks(state.pos, obj.element_indices, obj.ref_inv,
                       obj.volume, obj.mu, obj.s_lambda)
    dt = 5e-3
    a, _ = oracle._dense_system(dt)
    d, n = dim, obj.particle_cnt
    want = np.stack([a[i * d:(i + 1) * d, i * d:(i + 1) * d]
                     for i in range(n)])
    got = np.asarray(diagonal_blocks(obj, K, dt))
    _close(got - np.eye(d), want - np.eye(d), 2e-5)


@pytest.mark.parametrize("dim", DIMS)
def test_gather_plan_covers_each_row_once(dim):
    """The (two-tier) gather plan visits every (element, local vertex)
    contribution row exactly once, and gather assembly equals segment-sum."""
    obj, state, _ = _body(dim, seed=6)
    idx = np.asarray(obj.element_indices)
    n = obj.particle_cnt
    plan = build_gather_plan(idx, n)
    lo, hi, out = split_two_tier(plan, np.bincount(idx.reshape(-1),
                                                   minlength=n))
    rows = [lo.reshape(-1)] + ([] if hi is None else [hi.reshape(-1)])
    rows = np.concatenate(rows)
    rows = rows[rows != idx.size]
    assert np.array_equal(np.sort(rows), np.arange(idx.size))
    cols = explicit_grad_columns(state.pos, obj.element_indices, obj.ref_inv,
                                 obj.volume, obj.mu, obj.s_lambda)
    _close(_assembled(obj, cols),
           _assembled(obj.replace(assembly_mode="segment"), cols), 1e-6)


# -- solvers -----------------------------------------------------------------

@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("preconditioned", [0, 1])
def test_cg_solve_matches_oracle(dim, preconditioned):
    obj, state, oracle = _body(dim, seed=7)
    got, aux = implicit_velocity_solve(obj, state, 2e-3, 1, preconditioned)
    oracle.solve_cg(2e-3, preconditioned)
    np.testing.assert_allclose(np.asarray(got.vel), oracle.vel, atol=2e-3)
    assert int(aux.iterations) > 0


@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("preconditioned", [0, 1])
def test_cg_iterations_match_oracle(dim, preconditioned):
    """Same CG semantics (x₀ = b, absolute rᵀr tolerance, normal equations
    when preconditioned): the iteration counts agree within one."""
    obj, state, oracle = _body(dim, seed=8)
    _, aux = implicit_velocity_solve(obj, state, 2e-3, 1, preconditioned)
    oracle.solve_cg(2e-3, preconditioned)
    assert oracle.cg_iterations > 1
    assert abs(int(aux.iterations) - oracle.cg_iterations) <= 1


@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("sweep", ["serial", "snapshot"])
def test_jacobi_solve_matches_oracle(dim, sweep):
    obj, state, oracle = _body(dim, seed=9)
    got, _ = implicit_velocity_solve(obj, state, DT, 0, 0,
                                     jacobi_sweep=sweep)
    oracle.solve_jacobi(DT, sweep)
    np.testing.assert_allclose(np.asarray(got.vel), oracle.vel, atol=1e-4)
    np.testing.assert_allclose(
        np.asarray(got.jacobi_past_x), oracle._jacobi_past.reshape(
            oracle.n, oracle.d
        ), atol=1e-4,
    )
