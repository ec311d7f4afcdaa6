# coding=utf-8
"""Material extensions on the implicit fast paths (round-4, VERDICT r3 #2).

Each material (stvk / linear / corotated) rides the reference's decoupled
one-block-per-element Hessian structure (reference solver/implicit.py:
141-194) with its own analytic ``DP(F)[R_inv]`` integrand
(ops/element.first_piola_dp), so both operators (graph/mxu) serve every
material.  These tests pin:

  * the analytic DP against a jvp oracle of the analytic Piola (exact for
    stvk/linear; fixed-R jvp for corotated);
  * the analytic force columns against a float64 autodiff gradient of the
    energy, and the matrix-free operator / solve against a dense numpy
    assembly of the reference's A;
  * the decoupled-Hessian implicit step against the exact-Newton
    (hessian="exact_jvp") step — different linearizations of the same force,
    so velocities agree to O(dt²·coupling);
  * the differentiable substeps' forward parity for non-NH materials
    (ADVICE r3: diff.py silently simulated NH for every material).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fem_tpu.models.state import Obstacles, build_object
from fem_tpu.ops import smallmat as sm
from fem_tpu.ops.element import (
    first_piola,
    first_piola_dp,
    hessian_blocks,
)
from fem_tpu.sim import make_frame_fn, make_substep_fn
from fem_tpu.utils.config import BlockConfig, ObjectConfig, SimConfig
from tests.utils import (
    attach_edge_matrix,
    default_obstacles,
    default_sim_config_3d,
    dense_system_from_blocks,
    energy_gradient_f64,
    make_2d_object,
    make_3d_object,
    two_tet_object,
)

MATERIALS = (
    "stvk", "linear", "corotated", "stable_neo_hookean", "mooney_rivlin:0.3"
)


def _rand_f(d, n=6, scale=0.3, seed=0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(
        np.eye(d) + scale * rng.standard_normal((n, d, d)), jnp.float32
    )


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize(
    "material", ["stvk", "linear", "stable_neo_hookean", "mooney_rivlin:0.25"]
)
def test_first_piola_dp_matches_jvp(dim, material):
    """stvk/linear DP is the exact derivative of the analytic Piola."""
    F = _rand_f(dim)
    D = jnp.asarray(
        np.random.default_rng(1).standard_normal((6, dim, dim)), jnp.float32
    )
    mu, lam = 13.0, 7.0
    _, jv = jax.jvp(lambda f: first_piola(f, mu, lam, material), (F,), (D,))
    an = first_piola_dp(F, D, mu, lam, material)
    np.testing.assert_allclose(np.asarray(an), np.asarray(jv), atol=1e-4)


@pytest.mark.parametrize("dim", [2, 3])
def test_first_piola_dp_corotated_fixed_r(dim):
    """Corotated DP is the fixed-rotation linearization: it equals the jvp
    of P with R = polar(F) stop-gradiented (δR terms dropped by design —
    the decoupled-Hessian analog of the reference's i==j-only blocks)."""
    F = _rand_f(dim, seed=2)
    D = jnp.asarray(
        np.random.default_rng(3).standard_normal((6, dim, dim)), jnp.float32
    )
    mu, lam = 13.0, 7.0

    def p_fixed_r(f):
        r = sm.polar_rotation(jax.lax.stop_gradient(F))
        s_tr = (sm.trace(sm.matmul(sm.mT(r), f)) - dim)[..., None, None]
        return 2.0 * mu * (f - r) + lam * s_tr * r

    _, jv = jax.jvp(p_fixed_r, (F,), (D,))
    an = first_piola_dp(F, D, mu, lam, "corotated")
    np.testing.assert_allclose(np.asarray(an), np.asarray(jv), atol=1e-4)


def test_hessian_blocks_nh_default_unchanged():
    """The material dispatch must keep the NH formula bit-identical (it is
    the reference-parity path)."""
    _, obj, state = two_tet_object()
    k_default = hessian_blocks(
        state.pos, obj.element_indices, obj.ref_inv, obj.volume, 10.0, 5.0
    )
    k_named = hessian_blocks(
        state.pos, obj.element_indices, obj.ref_inv, obj.volume, 10.0, 5.0,
        False, "neo_hookean",
    )
    assert (np.asarray(k_default) == np.asarray(k_named)).all()


@pytest.mark.parametrize("material", MATERIALS)
def test_operator_matches_dense_assembly(material):
    """The matrix-free operator on a material's K blocks equals the dense
    numpy assembly of A from the same blocks (reference scatter loop)."""
    from fem_tpu.solvers.implicit import make_system_apply

    _, obj, state = make_2d_object(subdivisions=4)
    pos = state.pos + 0.01 * jnp.sin(jnp.arange(state.pos.size)).reshape(
        state.pos.shape
    )
    K = hessian_blocks(
        pos, obj.element_indices, obj.ref_inv, obj.volume, obj.mu,
        obj.s_lambda, False, material,
    )
    dt = 5e-3
    x = jnp.cos(jnp.arange(state.pos.size, dtype=jnp.float32)).reshape(
        state.pos.shape
    )
    got = np.asarray(make_system_apply(obj, K, dt)(x)).reshape(-1)
    want = dense_system_from_blocks(obj, K, dt) @ np.asarray(
        x, np.float64
    ).reshape(-1)
    np.testing.assert_allclose(
        got, want, rtol=0, atol=2e-6 * np.abs(want).max()
    )


@pytest.mark.parametrize("material", MATERIALS)
def test_explicit_columns_match_energy_gradient(material):
    """The analytic force columns, assembled, equal the float64 autodiff
    gradient of the material's total energy."""
    from fem_tpu.solvers.explicit import analytic_energy_gradient

    _, obj, state = two_tet_object()
    obj = obj.replace(material=material)
    pos = state.pos * jnp.float32(1.05)
    got = np.asarray(analytic_energy_gradient(obj, pos))
    want = energy_gradient_f64(obj, pos)
    np.testing.assert_allclose(
        got, want, rtol=0, atol=3e-5 * np.abs(want).max()
    )


def _implicit_cfg(**kw):
    base = dict(
        dim=2,
        delta_time=5e-4,
        sim_count=4,
        use_explicit_method=False,
        auto_diff=False,
        implicit_method=1,
        preconditioned=0,
        g_dir=(0.0, -1.0),
    )
    base.update(kw)
    return SimConfig(**base)


@pytest.mark.parametrize("material", MATERIALS)
def test_implicit_decoupled_close_to_exact_newton(material):
    """One implicit substep with the material decoupled Hessian vs the true
    Newton operator: both solve (I − dt²M⁻¹·J)x = b with the SAME rhs b but
    different J, so |Δvel| = O(dt²·‖ΔJ‖) — tiny at dt=5e-4."""
    _, obj, state = make_2d_object(subdivisions=4)
    obj = obj.replace(material=material)
    state = state.replace(vel=state.vel + 0.3)  # nonzero rhs
    cfg_dec = _implicit_cfg()
    cfg_exact = _implicit_cfg(hessian="exact_jvp", operator_mode="graph")
    obs = default_obstacles()
    s_dec, _ = make_substep_fn(obj, cfg_dec)(state, obs)
    s_exact, _ = make_substep_fn(obj, cfg_exact)(state, obs)
    np.testing.assert_allclose(
        np.asarray(s_dec.vel), np.asarray(s_exact.vel), rtol=0, atol=1e-4
    )
    assert np.isfinite(np.asarray(s_dec.pos)).all()


@pytest.mark.parametrize("material", MATERIALS)
def test_implicit_materials_all_operator_modes_agree(material):
    """graph and mxu (dense edge matrix) operator modes produce the same
    substep for every material."""
    _, obj, state = make_2d_object(subdivisions=4)
    obj = obj.replace(material=material)
    state = state.replace(vel=state.vel - 0.2)
    obs = default_obstacles()
    results = {}
    for mode, o in (("graph", obj), ("mxu", attach_edge_matrix(obj))):
        cfg = _implicit_cfg(operator_mode=mode)
        s, aux = make_substep_fn(o, cfg)(state, obs)
        results[mode] = np.asarray(s.vel)
        assert np.isfinite(results[mode]).all()
    np.testing.assert_allclose(
        results["mxu"], results["graph"], rtol=0, atol=2e-5
    )


@pytest.mark.parametrize("material", MATERIALS)
def test_implicit_material_solve_matches_dense_system(material):
    """The semi-implicit CG solve for each material satisfies the densely
    assembled system A·v = b to the reference's absolute tolerance, with b
    from the float64 energy gradient."""
    from fem_tpu.solvers.implicit import implicit_velocity_solve

    _, obj, state = make_2d_object(subdivisions=4)
    obj = obj.replace(material=material)
    rng = np.random.default_rng(5)
    state = state.replace(
        pos=state.pos + 0.004 * jnp.asarray(
            rng.standard_normal(state.pos.shape), jnp.float32
        ),
        vel=state.vel + 0.1,
    )
    dt = 5e-4
    solved, aux = implicit_velocity_solve(obj, state, dt, 1, 0)
    K = hessian_blocks(
        state.pos, obj.element_indices, obj.ref_inv, obj.volume, obj.mu,
        obj.s_lambda, False, material,
    )
    a = dense_system_from_blocks(obj, K, dt)
    mass = np.asarray(obj.mass, np.float64)[:, None]
    b = np.asarray(state.vel, np.float64) - dt * energy_gradient_f64(
        obj, state.pos
    ) / mass
    r = b.reshape(-1) - a @ np.asarray(solved.vel, np.float64).reshape(-1)
    assert int(aux.iterations) > 0
    assert float(r @ r) <= 2e-5


def test_stvk_frame_equals_repeated_substeps():
    """A 3D stvk frame (one lax.scan over sim_count substeps) equals the
    same number of single compiled substeps."""
    _, obj, state = make_3d_object(subdivisions=3, material="stvk")
    state = state.replace(vel=state.vel - 0.3)
    obs = Obstacles.from_configs((), 3)
    cfg = default_sim_config_3d(sim_count=3, preconditioned=0)
    s_frame, _ = make_frame_fn(obj, cfg)(state, obs)
    step = make_substep_fn(obj, cfg)
    s = state
    for _ in range(cfg.sim_count):
        s, _ = step(s, obs)
    np.testing.assert_allclose(
        np.asarray(s_frame.pos), np.asarray(s.pos), rtol=0, atol=1e-6
    )


def test_diff_explicit_substep_uses_material():
    """ADVICE r3 (medium): the differentiable explicit substep must simulate
    the object's material, not silently NH — forward parity vs the non-diff
    explicit path for stvk."""
    from fem_tpu.diff import make_diff_substep_fn, params_from_object

    _, obj, state = make_2d_object(subdivisions=4)
    obj = obj.replace(material="stvk")
    cfg = SimConfig(
        dim=2, delta_time=5e-4, sim_count=1, auto_diff=False,
        use_explicit_method=True, g_dir=(0.0, -1.0),
    )
    obs = default_obstacles()
    sub = make_diff_substep_fn(obj, cfg)
    s_diff = sub(params_from_object(obj), state, obs)
    s_ref, _ = make_substep_fn(obj, cfg)(state, obs)
    np.testing.assert_allclose(
        np.asarray(s_diff.pos), np.asarray(s_ref.pos), rtol=0, atol=1e-6
    )
    # And gradients w.r.t. mu flow and are finite / material-dependent.
    def loss(params):
        s = sub(params, state, obs)
        return jnp.sum(s.pos ** 2)

    g = jax.grad(loss)(params_from_object(obj))
    assert np.isfinite(float(g.mu))


def test_diff_implicit_substep_uses_material():
    """Same for the differentiable implicit substep (corotated)."""
    from fem_tpu.diff import make_diff_substep_fn, params_from_object

    _, obj, state = make_2d_object(subdivisions=3)
    obj = obj.replace(material="corotated")
    state = state.replace(vel=state.vel + 0.2)
    cfg = _implicit_cfg(preconditioned=1)
    obs = default_obstacles()
    sub = make_diff_substep_fn(obj, cfg, n_cg_iters=40)
    s_diff = sub(params_from_object(obj), state, obs)
    s_ref, _ = make_substep_fn(
        obj, dataclasses.replace(cfg, operator_mode="graph")
    )(state, obs)
    # Fixed-iteration normal-equations CG vs the reference while_loop —
    # solver-tolerance agreement (documented diff.py deviation).
    np.testing.assert_allclose(
        np.asarray(s_diff.vel), np.asarray(s_ref.vel), rtol=0, atol=5e-4
    )
    assert np.isfinite(np.asarray(s_diff.pos)).all()


# --- Mooney–Rivlin (framework extension; ops/element.mooney_params) ------


def test_mooney_rivlin_beta0_is_neo_hookean():
    """mooney_rivlin:0.0 reduces EXACTLY to the reference NH model —
    C2 = 0 collapses the energy to μ/2(I₁−d) − μ·logJ + λ/2·logJ²."""
    from fem_tpu.ops.element import energy_density

    for d in (2, 3):
        F = _rand_f(d)
        mu, lam = 13.0, 7.0
        for fn in (energy_density, first_piola):
            a = fn(F, mu, lam, "mooney_rivlin:0.0")
            b = fn(F, mu, lam, "neo_hookean")
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), rtol=0, atol=2e-5
            )
        D = jnp.asarray(
            np.random.default_rng(2).standard_normal((6, d, d)), jnp.float32
        )
        np.testing.assert_allclose(
            np.asarray(first_piola_dp(F, D, mu, lam, "mooney_rivlin:0.0")),
            np.asarray(first_piola_dp(F, D, mu, lam, "neo_hookean")),
            rtol=0, atol=2e-5,
        )


@pytest.mark.parametrize("dim", [2, 3])
def test_mooney_rivlin_piola_is_energy_gradient(dim):
    """P = ∂φ/∂F exactly (autodiff oracle), and rest state is stress-free."""
    from fem_tpu.ops.element import energy_density

    F = _rand_f(dim)
    mu, lam = 13.0, 20.0
    mat = "mooney_rivlin:0.4"
    g = jax.vmap(jax.grad(lambda f: energy_density(f, mu, lam, mat)))(F)
    np.testing.assert_allclose(
        np.asarray(first_piola(F, mu, lam, mat)), np.asarray(g),
        rtol=0, atol=1e-4,
    )
    eye = jnp.broadcast_to(jnp.eye(dim, dtype=jnp.float32), (1, dim, dim))
    assert np.abs(np.asarray(first_piola(eye, mu, lam, mat))).max() == 0.0


@pytest.mark.parametrize("dim", [2, 3])
def test_mooney_rivlin_small_strain_matches_linear_elasticity(dim):
    """The calibration pins DP(I)[D] to linear elasticity with the object's
    (μ, λ) in BOTH dimensions (C1 = μ/2 − (d−2)C2, λ_log = λ − 4C2)."""
    D = jnp.asarray(
        np.random.default_rng(3).standard_normal((4, dim, dim)), jnp.float32
    )
    eye = jnp.broadcast_to(jnp.eye(dim, dtype=jnp.float32), D.shape)
    mu, lam = 13.0, 20.0
    for beta in (0.0, 0.2, 0.5):
        got = first_piola_dp(eye, D, mu, lam, f"mooney_rivlin:{beta}")
        want = first_piola_dp(eye, D, mu, lam, "linear")
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(want), rtol=0, atol=1e-4
        )


def test_mooney_rivlin_infeasible_calibration_raises():
    """λ < 4C2 (volumetric log term turning concave) raises loudly at
    trace time, naming the fix."""
    from fem_tpu.ops.element import mooney_params

    with pytest.raises(ValueError, match="beta"):
        mooney_params(10.0, 1.0, 3, "mooney_rivlin:0.9")
    with pytest.raises(ValueError, match="beta must be in"):
        mooney_params(10.0, 100.0, 3, "mooney_rivlin:1.5")


def test_mooney_rivlin_implicit_simulation_runs():
    """End-to-end semi-implicit CG frame with mooney_rivlin — rides the
    decoupled ladder like every other material (finite, settles)."""
    _, obj, state = make_2d_object(subdivisions=3)
    obj = obj.replace(material="mooney_rivlin:0.3")
    cfg = _implicit_cfg()
    frame = make_frame_fn(obj, cfg)
    obs = default_obstacles()
    for _ in range(3):
        state, aux = frame(state, obs)
    assert np.isfinite(np.asarray(state.pos)).all()
