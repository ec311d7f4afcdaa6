# coding=utf-8
"""Transversely isotropic fiber-reinforced material (framework extension,
``material="fiber:a1,a2[,a3][:kappa]"`` — ops/element.fiber_params).

The reference has isotropic materials only; this is the anisotropic rung of
the material ladder: stable-Neo-Hookean base + the standard-reinforcing
term k/2·(I₄ − 1)², I₄ = |Fa|², k = kappa·μ.  Tests pin exactness of the
analytic derivatives (P = ∂φ/∂F, DP = exact jvp of P — both polynomial),
rest stability, objectivity, fiber-direction stiffening, the force columns
and operator against f64 autodiff and dense assembly, and integration on the
explicit / semi-implicit
(decoupled Hessian) / Newton paths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fem_tpu.ops.element import (
    energy_density,
    fiber_params,
    first_piola,
    first_piola_dp,
    hessian_blocks,
)
from fem_tpu.sim import make_substep_fn
from fem_tpu.utils.config import SimConfig
from tests.utils import (
    attach_edge_matrix,
    default_obstacles,
    dense_system_from_blocks,
    energy_gradient_f64,
    make_2d_object,
    two_tet_object,
)

FIB2 = "fiber:0.6,0.8:2.0"
FIB3 = "fiber:0.0,0.6,0.8:2.0"


def _mat(d):
    return FIB2 if d == 2 else FIB3


def _rand_f(d, n=6, scale=0.2, seed=0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(
        np.eye(d) + scale * rng.standard_normal((n, d, d)), jnp.float32
    )


def test_fiber_params_parse_and_validate():
    a, k = fiber_params(10.0, 2, "fiber:3,4")
    np.testing.assert_allclose(a, (0.6, 0.8))
    assert k == 10.0  # kappa defaults to 1.0 => k = mu
    _, k = fiber_params(10.0, 3, "fiber:0,0,2:0.5")
    assert k == 5.0
    with pytest.raises(ValueError):
        fiber_params(10.0, 3, "fiber:1,0")  # wrong component count
    with pytest.raises(ValueError):
        fiber_params(10.0, 2, "fiber:0,0")  # zero direction
    with pytest.raises(ValueError):
        fiber_params(10.0, 2, "fiber:1,0:-1")  # bad kappa


@pytest.mark.parametrize("dim", [2, 3])
def test_piola_is_energy_gradient(dim):
    F = _rand_f(dim)
    mu, lam = 1.3e4, 2.1e4
    g = jax.vmap(
        jax.grad(lambda f: energy_density(f, mu, lam, _mat(dim)))
    )(F)
    p = first_piola(F, mu, lam, _mat(dim))
    scale = float(jnp.abs(p).max())
    np.testing.assert_allclose(
        np.asarray(g), np.asarray(p), rtol=0, atol=2e-6 * scale
    )


@pytest.mark.parametrize("dim", [2, 3])
def test_dp_is_exact_jvp(dim):
    F = _rand_f(dim)
    D = jnp.asarray(
        np.random.default_rng(1).standard_normal((6, dim, dim)), jnp.float32
    )
    mu, lam = 1.3e4, 2.1e4
    _, jv = jax.jvp(
        lambda f: first_piola(f, mu, lam, _mat(dim)), (F,), (D,)
    )
    dp = first_piola_dp(F, D, mu, lam, _mat(dim))
    scale = float(jnp.abs(dp).max())
    np.testing.assert_allclose(
        np.asarray(jv), np.asarray(dp), rtol=0, atol=2e-6 * scale
    )


@pytest.mark.parametrize("dim", [2, 3])
def test_rest_stable_objective_and_finite_through_inversion(dim):
    eye = jnp.broadcast_to(jnp.eye(dim, dtype=jnp.float32), (2, dim, dim))
    mu, lam = 1e4, 2e4
    assert float(jnp.abs(energy_density(eye, mu, lam, _mat(dim))).max()) == 0.0
    assert float(jnp.abs(first_piola(eye, mu, lam, _mat(dim))).max()) == 0.0
    # Objectivity: φ(QF) = φ(F) for a rigid rotation Q (I₄ and the base's
    # invariants are all left-rotation invariant).
    F = _rand_f(dim, n=4)
    th = 0.7
    q2 = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    q = np.eye(dim)
    q[:2, :2] = q2
    qf = jnp.einsum("ij,ejk->eik", jnp.asarray(q, jnp.float32), F)
    e0 = np.asarray(energy_density(F, mu, lam, _mat(dim)))
    e1 = np.asarray(energy_density(qf, mu, lam, _mat(dim)))
    np.testing.assert_allclose(e1, e0, rtol=3e-5)
    # Polynomial in F: finite for inverted elements (like its stable-NH base).
    assert np.isfinite(
        np.asarray(energy_density(-F, mu, lam, _mat(dim)))
    ).all()


def test_fiber_term_is_additive_over_stable_nh():
    """φ_fiber − φ_base == k/2·(I₄−1)² exactly, and the direction is
    normalized (fiber:3,4 ≡ fiber:0.6,0.8)."""
    F = _rand_f(2)
    mu, lam = 1e4, 2e4
    base = energy_density(F, mu, lam, "stable_neo_hookean")
    fib = energy_density(F, mu, lam, "fiber:3,4:2.0")
    a = jnp.asarray([0.6, 0.8], jnp.float32)
    fa = jnp.einsum("eij,j->ei", F, a)
    i4 = jnp.sum(fa * fa, axis=-1)
    expect = base + 0.5 * (2.0 * mu) * (i4 - 1.0) ** 2
    np.testing.assert_allclose(
        np.asarray(fib), np.asarray(expect), rtol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(energy_density(F, mu, lam, "fiber:0.6,0.8:2.0")),
        np.asarray(fib),
        rtol=1e-6,
    )


def test_stretch_along_fiber_stiffer_than_across():
    mu, lam = 1e4, 2e4
    a = np.array([0.6, 0.8])
    b = np.array([-0.8, 0.6])
    s_along = jnp.asarray(
        (np.eye(2) + 0.1 * np.outer(a, a))[None].astype(np.float32)
    )
    s_across = jnp.asarray(
        (np.eye(2) + 0.1 * np.outer(b, b))[None].astype(np.float32)
    )
    e_along = float(energy_density(s_along, mu, lam, FIB2)[0])
    e_across = float(energy_density(s_across, mu, lam, FIB2)[0])
    assert e_along > 2.0 * e_across, (e_along, e_across)
    # ... and the anisotropy is exactly the fiber term: the base treats the
    # two stretches identically.
    b_along = float(energy_density(s_along, mu, lam, "stable_neo_hookean")[0])
    b_across = float(
        energy_density(s_across, mu, lam, "stable_neo_hookean")[0]
    )
    np.testing.assert_allclose(b_along, b_across, rtol=1e-5)


def test_fiber_operator_matches_dense_assembly_2d():
    """The matrix-free operator on fiber K blocks equals the dense numpy
    assembly of A from the same blocks."""
    from fem_tpu.solvers.implicit import make_system_apply

    _, obj, state = make_2d_object(subdivisions=4)
    pos = state.pos + 0.01 * jnp.sin(jnp.arange(state.pos.size)).reshape(
        state.pos.shape
    )
    K = hessian_blocks(
        pos, obj.element_indices, obj.ref_inv, obj.volume, obj.mu,
        obj.s_lambda, False, FIB2,
    )
    x = jnp.cos(jnp.arange(state.pos.size, dtype=jnp.float32)).reshape(
        state.pos.shape
    )
    got = np.asarray(make_system_apply(obj, K, 5e-3)(x)).reshape(-1)
    want = dense_system_from_blocks(obj, K, 5e-3) @ np.asarray(
        x, np.float64
    ).reshape(-1)
    np.testing.assert_allclose(
        got, want, rtol=0, atol=2e-6 * np.abs(want).max()
    )


def test_explicit_fiber_columns_match_energy_gradient_3d():
    """Assembled analytic fiber force columns equal the float64 autodiff
    gradient of the fiber energy."""
    from fem_tpu.solvers.explicit import analytic_energy_gradient

    _, obj, state = two_tet_object()
    obj = obj.replace(material=FIB3)
    pos = state.pos * jnp.float32(1.05)
    got = np.asarray(analytic_energy_gradient(obj, pos))
    want = energy_gradient_f64(obj, pos)
    np.testing.assert_allclose(
        got, want, rtol=0, atol=3e-5 * np.abs(want).max()
    )


def _implicit_cfg(**kw):
    base = dict(
        dim=2, delta_time=5e-4, sim_count=4, use_explicit_method=False,
        auto_diff=False, implicit_method=1, preconditioned=0,
        g_dir=(0.0, -1.0),
    )
    base.update(kw)
    return SimConfig(**base)


def test_implicit_decoupled_close_to_exact_newton():
    _, obj, state = make_2d_object(subdivisions=4)
    obj = obj.replace(material=FIB2)
    state = state.replace(vel=state.vel + 0.3)
    obs = default_obstacles()
    s_dec, _ = make_substep_fn(obj, _implicit_cfg())(state, obs)
    s_exact, _ = make_substep_fn(
        obj, _implicit_cfg(hessian="exact_jvp", operator_mode="graph")
    )(state, obs)
    np.testing.assert_allclose(
        np.asarray(s_dec.vel), np.asarray(s_exact.vel), rtol=0, atol=1e-4
    )


def test_implicit_mxu_operator_matches_graph():
    _, obj, state = make_2d_object(subdivisions=4)
    obj = obj.replace(material=FIB2)
    state = state.replace(vel=state.vel + 0.1)
    obs = default_obstacles()
    s_x, _ = make_substep_fn(
        obj, _implicit_cfg(operator_mode="graph")
    )(state, obs)
    s_p, _ = make_substep_fn(
        attach_edge_matrix(obj), _implicit_cfg(operator_mode="mxu")
    )(state, obs)
    np.testing.assert_allclose(
        np.asarray(s_p.vel), np.asarray(s_x.vel), rtol=0, atol=3e-5
    )


def test_fiber_dynamics_anisotropic_sag():
    """A block under gravity with VERTICAL fibers sags less than one with
    HORIZONTAL fibers — the observable consequence of the anisotropy
    (explicit analytic path, 60 substeps)."""
    cfg = SimConfig(
        dim=2, delta_time=5e-4, sim_count=4, use_explicit_method=True,
        auto_diff=False, g_dir=(0.0, -1.0),
    )
    obs = default_obstacles()

    def min_y(material):
        _, obj, state = make_2d_object(subdivisions=4, center=(0.5, 0.5))
        obj = obj.replace(material=material)
        fn = make_substep_fn(obj, cfg)
        for _ in range(60):
            state, _ = fn(state, obs)
        assert np.isfinite(np.asarray(state.pos)).all()
        return float(np.asarray(state.pos)[:, 1].min())

    y_vert = min_y("fiber:0,1:4.0")
    y_horiz = min_y("fiber:1,0:4.0")
    assert y_vert > y_horiz + 1e-5, (y_vert, y_horiz)


def test_newton_integrator_runs_fiber():
    _, obj, state = make_2d_object(subdivisions=4)
    obj = obj.replace(material=FIB2)
    cfg = _implicit_cfg(
        integrator="newton", newton_hessian="decoupled", newton_tol=1e-5
    )
    fn = make_substep_fn(obj, cfg)
    obs = default_obstacles()
    for _ in range(10):
        state, aux = fn(state, obs)
    assert np.isfinite(np.asarray(state.pos)).all()
    assert float(aux.solver_residual) <= (1e-5) ** 2 + 1e-10
