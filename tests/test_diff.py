# coding=utf-8
"""Differentiable-simulation extension (fem_tpu/diff.py).

The reference can only tape one substep's energy (main.py:107); these tests
pin the framework extension: gradients THROUGH trajectories w.r.t. material
parameters, verified against central finite differences, and forward parity
of the diff substeps against the non-diff paths."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fem_tpu.diff import (
    DiffParams,
    lame_from_young,
    make_diff_rollout_fn,
    make_diff_substep_fn,
    params_from_object,
    trajectory_loss_fn,
)
from fem_tpu.models.state import Obstacles
from fem_tpu.sim import make_substep_fn
from tests.utils import (
    default_obstacles,
    default_sim_config,
    default_sim_config_3d,
    make_2d_object,
    make_3d_object,
)


def _squashed(state, scale=(1.25, 1.1, 0.85)):
    """Anisotropically deform the body about its centroid so elastic forces
    (and hence the stiffness dependence) are non-zero from step 0 — a body in
    free fall at rest pose has F = I and zero force for ANY (mu, lambda).
    The scale is volume-changing (J != 1) so the lambda/log-J terms carry
    real signal too."""
    pos = state.pos
    c = pos.mean(axis=0, keepdims=True)
    s = jnp.asarray(scale[: pos.shape[1]], jnp.float32)[None, :]
    return state.replace(pos=c + (pos - c) * s)


def _loss_at(obj, cfg, state, obstacles, n_steps, mu, lam, damping,
             n_cg_iters=32):
    rollout = make_diff_rollout_fn(obj, cfg, n_steps, n_cg_iters)
    params = DiffParams(jnp.float32(mu), jnp.float32(lam),
                        jnp.float32(damping))
    final, traj = rollout(params, state, obstacles)
    # A generic nonlinear functional of the trajectory.
    return jnp.mean(traj ** 2) + jnp.mean(final.vel ** 2)


@pytest.mark.parametrize(
    "cfg_kwargs",
    [
        dict(auto_diff=False, use_explicit_method=True),
        dict(auto_diff=True, use_explicit_method=False),
    ],
    ids=["explicit_analytic", "autodiff_energy"],
)
def test_explicit_grad_matches_fd(cfg_kwargs):
    _, obj, state = make_2d_object(subdivisions=3)
    state = _squashed(state)
    cfg = default_sim_config(**cfg_kwargs)
    obstacles = default_obstacles()
    n_steps = 12
    mu0, lam0, damp0 = float(obj.mu), float(obj.s_lambda), float(obj.damping)

    def loss(mu, lam, damping):
        return _loss_at(obj, cfg, state, obstacles, n_steps, mu, lam, damping)

    g = jax.grad(
        lambda p: loss(p.mu, p.s_lambda, p.damping)
    )(DiffParams(jnp.float32(mu0), jnp.float32(lam0), jnp.float32(damp0)))

    # Central differences, relative steps sized for f32.
    for name, base, grad_val in [
        ("mu", mu0, float(g.mu)),
        ("s_lambda", lam0, float(g.s_lambda)),
    ]:
        eps = 1e-3 * base
        kw = dict(mu=mu0, lam=lam0, damping=damp0)
        hi = dict(kw, **{("lam" if name == "s_lambda" else name): base + eps})
        lo = dict(kw, **{("lam" if name == "s_lambda" else name): base - eps})
        fd = (float(loss(hi["mu"], hi["lam"], hi["damping"]))
              - float(loss(lo["mu"], lo["lam"], lo["damping"]))) / (2 * eps)
        assert abs(grad_val) > 0.0, name  # deformed start => real signal
        assert grad_val == pytest.approx(fd, rel=5e-2, abs=1e-12), name


def test_implicit_grad_matches_fd():
    _, obj, state = make_2d_object(subdivisions=3)
    state = _squashed(state)
    cfg = default_sim_config(
        auto_diff=False, use_explicit_method=False, implicit_method=1,
        preconditioned=1,
    )
    obstacles = default_obstacles()
    n_steps = 8
    mu0, lam0, damp0 = float(obj.mu), float(obj.s_lambda), float(obj.damping)

    def loss(mu):
        return _loss_at(obj, cfg, state, obstacles, n_steps, mu, lam0, damp0,
                        n_cg_iters=48)

    g = float(jax.grad(loss)(jnp.float32(mu0)))
    assert abs(g) > 0.0
    eps = 1e-3 * mu0
    fd = (float(loss(jnp.float32(mu0 + eps)))
          - float(loss(jnp.float32(mu0 - eps)))) / (2 * eps)
    assert g == pytest.approx(fd, rel=5e-2, abs=1e-12)


def test_grad_wrt_initial_state():
    """The initial state is an ordinary traced argument: gradients w.r.t.
    initial velocity flow through the rollout (inverse initial conditions)."""
    _, obj, state = make_2d_object(subdivisions=2)
    cfg = default_sim_config(auto_diff=False, use_explicit_method=True)
    obstacles = default_obstacles()
    rollout = make_diff_rollout_fn(obj, cfg, 10)
    params = params_from_object(obj)

    def loss(v0):
        final, _ = rollout(params, state.replace(vel=v0), obstacles)
        return jnp.mean(final.pos ** 2)

    v0 = jnp.zeros_like(state.vel)
    g = jax.grad(loss)(v0)
    assert g.shape == v0.shape
    assert np.isfinite(np.asarray(g)).all()
    assert float(jnp.abs(g).max()) > 0.0
    e = jnp.zeros_like(v0).at[3, 1].set(1.0)
    eps = 1e-3
    fd = (float(loss(v0 + eps * e)) - float(loss(v0 - eps * e))) / (2 * eps)
    assert float(g[3, 1]) == pytest.approx(fd, rel=5e-2, abs=1e-10)


@pytest.mark.parametrize(
    "cfg_kwargs",
    [
        dict(auto_diff=False, use_explicit_method=True),
        dict(auto_diff=True, use_explicit_method=False),
    ],
    ids=["explicit_analytic", "autodiff_energy"],
)
def test_diff_forward_matches_parity_path_explicit(cfg_kwargs):
    """With params lifted from the object, the explicit diff substep computes
    the exact arithmetic of the op-composed XLA path."""
    _, obj, state = make_2d_object(subdivisions=4)
    cfg = default_sim_config(**cfg_kwargs)
    obstacles = default_obstacles()
    sub_ref = make_substep_fn(obj, cfg)
    sub_diff = jax.jit(make_diff_substep_fn(obj, cfg))
    params = params_from_object(obj)
    s_ref, s_diff = state, state
    for _ in range(20):
        s_ref, _ = sub_ref(s_ref, obstacles)
        s_diff = sub_diff(params, s_diff, obstacles)
    np.testing.assert_allclose(
        np.asarray(s_diff.pos), np.asarray(s_ref.pos), rtol=0, atol=1e-6
    )


def test_diff_implicit_substep_matches_dense_f64_solve():
    """Single implicit diff substep == the float64 dense normal-equations
    solution of the SAME system, advected identically — i.e. the
    custom_linear_solve path solves the reference's linear system, tightly.
    (The non-diff parity path differs by the reference's deliberately loose
    absolute CG tolerance — delta_new > 1e-5, implicit.py:341 — so the
    honest oracle here is the dense solve, not the loose solver.)"""
    from fem_tpu.models.state import dense_system_matrix
    from fem_tpu.solvers.advect import advect_implicit_step

    _, obj, state = make_3d_object(subdivisions=2)
    state = _squashed(state)
    cfg = default_sim_config_3d(operator_mode="graph")
    obstacles = Obstacles.from_configs((), 3)
    params = params_from_object(obj)
    sub_diff = jax.jit(make_diff_substep_fn(obj, cfg, n_cg_iters=128))
    s_diff = sub_diff(params, state, obstacles)

    # Oracle: dense A (float64), b from the same element ops, x = (AtA)^-1 At b.
    from fem_tpu.ops.assembly import assemble_for, element_contrib_full
    from fem_tpu.ops.element import implicit_force_columns

    dt = cfg.delta_time
    ad = dense_system_matrix(obj, state, dt).astype(np.float64)
    cols = implicit_force_columns(
        state.pos, obj.element_indices, obj.ref_inv, obj.volume,
        obj.mu, obj.s_lambda,
    )
    f = assemble_for(obj, element_contrib_full(cols))
    b = np.asarray(state.vel + dt * f / obj.mass[:, None], np.float64)
    x = np.linalg.solve(ad.T @ ad, ad.T @ b.reshape(-1))
    s_oracle = advect_implicit_step(
        state.replace(vel=jnp.asarray(x.reshape(b.shape), jnp.float32)),
        obstacles, dt, obj.damping, tuple(cfg.g_dir),
    )
    np.testing.assert_allclose(
        np.asarray(s_diff.vel), np.asarray(s_oracle.vel), rtol=0, atol=2e-5
    )
    np.testing.assert_allclose(
        np.asarray(s_diff.pos), np.asarray(s_oracle.pos), rtol=0, atol=1e-6
    )


def test_diff_forward_tracks_parity_path_implicit():
    """Over a 15-substep trajectory the diff path tracks the non-diff parity
    path to the reference solver's own tolerance (the parity CG stops at an
    ABSOLUTE residual 1e-5 — per-substep velocity differences up to ~1e-3
    are the reference's solver slack, not a diff-path defect)."""
    _, obj, state = make_3d_object(subdivisions=2)
    state = _squashed(state)
    cfg = default_sim_config_3d(operator_mode="graph")
    obstacles = Obstacles.from_configs((), 3)
    sub_ref = make_substep_fn(obj, cfg)
    sub_diff = jax.jit(make_diff_substep_fn(obj, cfg, n_cg_iters=64))
    params = params_from_object(obj)
    s_ref, s_diff = state, state
    for _ in range(15):
        s_ref, _ = sub_ref(s_ref, obstacles)
        s_diff = sub_diff(params, s_diff, obstacles)
    np.testing.assert_allclose(
        np.asarray(s_diff.pos), np.asarray(s_ref.pos), rtol=0, atol=2e-2
    )


def test_implicit_diff_rollout_grad_finite_3d():
    _, obj, state = make_3d_object(subdivisions=2)
    state = _squashed(state)
    cfg = default_sim_config_3d()
    obstacles = Obstacles.from_configs((), 3)
    rollout = make_diff_rollout_fn(obj, cfg, 6, n_cg_iters=32)
    params = params_from_object(obj)

    def loss(p):
        final, traj = rollout(p, state, obstacles)
        return jnp.mean(traj ** 2)

    g = jax.grad(loss)(params)
    assert np.isfinite(float(g.mu))
    assert np.isfinite(float(g.s_lambda))
    assert np.isfinite(float(g.damping))
    assert abs(float(g.mu)) > 0.0


def test_inverse_material_recovery():
    """Gradient descent on E through the rollout recovers the target
    stiffness (the headline inverse problem, examples/inverse_material.py)."""
    _, obj, state = make_2d_object(subdivisions=3)
    state = _squashed(state)
    cfg = default_sim_config(auto_diff=False, use_explicit_method=True)
    obstacles = default_obstacles()
    n_steps = 25
    rollout = make_diff_rollout_fn(obj, cfg, n_steps)

    nu = 0.2
    e_true = 4e4

    def traj_of(log_e):
        mu, lam = lame_from_young(jnp.exp(log_e), nu)
        params = DiffParams(mu, lam, jnp.float32(obj.damping))
        _, traj = rollout(params, state, obstacles)
        return traj

    target = traj_of(jnp.log(jnp.float32(e_true)))
    loss = lambda log_e: jnp.mean((traj_of(log_e) - target) ** 2) * 1e6
    vg = jax.jit(jax.value_and_grad(loss))

    import optax

    opt = optax.adam(0.1)
    log_e = jnp.log(jnp.float32(2.0e4))  # start at half the true stiffness
    opt_state = opt.init(log_e)
    loss0 = float(vg(log_e)[0])
    best_loss, best_log_e = loss0, log_e
    for _ in range(60):
        val, g = vg(log_e)
        if float(val) < best_loss:
            best_loss, best_log_e = float(val), log_e
        updates, opt_state = opt.update(g, opt_state)
        log_e = optax.apply_updates(log_e, updates)
    e_rec = float(jnp.exp(best_log_e))
    assert best_loss < 0.01 * loss0  # loss collapsed
    assert e_rec == pytest.approx(e_true, rel=0.10)


def test_jacobi_config_rejected():
    _, obj, _ = make_2d_object(subdivisions=2)
    cfg = default_sim_config(
        auto_diff=False, use_explicit_method=False, implicit_method=0
    )
    with pytest.raises(ValueError, match="Jacobi"):
        make_diff_substep_fn(obj, cfg)


def test_trajectory_loss_fn_api():
    _, obj, state = make_2d_object(subdivisions=2)
    cfg = default_sim_config(auto_diff=False, use_explicit_method=True)
    obstacles = default_obstacles()
    rollout = make_diff_rollout_fn(obj, cfg, 5)
    params = params_from_object(obj)
    _, target = rollout(params, state, obstacles)
    loss = trajectory_loss_fn(obj, cfg, target)
    assert float(loss(params, state, obstacles)) == pytest.approx(0.0, abs=1e-12)
    g = jax.grad(loss)(params, state, obstacles)
    assert np.isfinite(float(g.mu))


def test_vmapped_param_gradients():
    """Batched inverse problems: vmap over candidate parameter sets gives
    per-member gradients in ONE compiled program (composes with the
    ensemble batching of fem_tpu/batch.py — a capability with no serial-GPU
    analogue in the reference)."""
    _, obj, state = make_2d_object(subdivisions=2)
    state = _squashed(state)
    cfg = default_sim_config(auto_diff=False, use_explicit_method=True)
    obstacles = default_obstacles()
    rollout = make_diff_rollout_fn(obj, cfg, 8)
    base = params_from_object(obj)

    def loss(p):
        _, traj = rollout(p, state, obstacles)
        return jnp.mean(traj ** 2)

    scales = jnp.asarray([0.5, 1.0, 2.0], jnp.float32)
    batch = DiffParams(
        mu=base.mu * scales, s_lambda=base.s_lambda * scales,
        damping=jnp.broadcast_to(base.damping, scales.shape),
    )
    vals, grads = jax.vmap(jax.value_and_grad(loss))(batch)
    assert vals.shape == (3,)
    assert np.isfinite(np.asarray(grads.mu)).all()
    # Member 1 is the base params: its grad must equal the unbatched grad.
    g_single = jax.grad(loss)(base)
    assert float(grads.mu[1]) == pytest.approx(float(g_single.mu), rel=1e-4)
    # Different stiffnesses must produce genuinely different gradients.
    assert abs(float(grads.mu[0]) - float(grads.mu[2])) > 0.0


def test_corotated_rollout_grad_matches_fd():
    """Material-parameter gradients through a corotated rollout: the polar
    iteration (smallmat.polar_rotation) must be differentiable inside
    jax.grad through time — incl. the first substep, which linearizes near
    the rest pose where SVD-based corotated formulations are undefined."""
    _, obj, state = make_2d_object(subdivisions=3)
    obj = obj.replace(material="corotated")
    state = _squashed(state)
    cfg = default_sim_config(auto_diff=True, use_explicit_method=False)
    obstacles = default_obstacles()
    n_steps = 8
    mu0, lam0, damp0 = float(obj.mu), float(obj.s_lambda), float(obj.damping)

    def loss(mu, lam):
        return _loss_at(obj, cfg, state, obstacles, n_steps, mu, lam, damp0)

    g = jax.grad(loss)(jnp.float32(mu0), jnp.float32(lam0))
    assert np.isfinite(float(g)) and abs(float(g)) > 0.0
    eps = 1e-3 * mu0
    fd = (float(loss(mu0 + eps, lam0)) - float(loss(mu0 - eps, lam0))) / (
        2 * eps
    )
    assert float(g) == pytest.approx(fd, rel=5e-2, abs=1e-12)


@pytest.mark.parametrize(
    "cfg_kwargs",
    [
        dict(auto_diff=False, use_explicit_method=True),
        dict(auto_diff=False, use_explicit_method=False,
             implicit_method=1, preconditioned=0),
    ],
    ids=["explicit_plastic", "implicit_plastic"],
)
def test_plastic_grad_matches_fd(cfg_kwargs):
    """Differentiable INELASTIC stepping (round 5): with a squashed start
    far past yield, gradients of a trajectory loss w.r.t. mu AND the
    traced plastic_yield must match central differences — the radial
    return map (componentwise Jacobi, no SVD) is piecewise smooth in
    both."""
    _, obj, state = make_2d_object(subdivisions=3, plastic_yield=0.05)
    assert state.plastic_inv is not None
    state = _squashed(state, scale=(1.35, 0.75))  # well past yield
    cfg = default_sim_config(**cfg_kwargs)
    obstacles = default_obstacles()
    n_steps = 10
    mu0, lam0, damp0 = float(obj.mu), float(obj.s_lambda), float(obj.damping)
    y0 = 0.05

    def loss(mu, y):
        rollout = make_diff_rollout_fn(obj, cfg, n_steps, 32)
        params = DiffParams(
            jnp.float32(mu), jnp.float32(lam0), jnp.float32(damp0),
            plastic_yield=jnp.float32(y),
        )
        final, traj = rollout(params, state, obstacles)
        return jnp.mean(traj ** 2) + jnp.mean(final.vel ** 2)

    g = jax.grad(loss, argnums=(0, 1))(jnp.float32(mu0), jnp.float32(y0))
    for name, base, grad_val, eps in [
        ("mu", mu0, float(g[0]), 1e-3 * mu0),
        ("plastic_yield", y0, float(g[1]), 1e-3),
    ]:
        if name == "mu":
            fd = (float(loss(base + eps, y0)) - float(loss(base - eps, y0))) / (2 * eps)
        else:
            fd = (float(loss(mu0, base + eps)) - float(loss(mu0, base - eps))) / (2 * eps)
        assert abs(grad_val) > 0.0, name
        assert grad_val == pytest.approx(fd, rel=8e-2, abs=1e-10), name


def test_viscoelastic_diff_forward_tracks_parity_path():
    """Diff stepping with the Maxwell branch: the forward trajectory must
    track the non-diff substep (same layered chain + relaxation)."""
    cfg_o, obj, state = make_2d_object(
        subdivisions=3, viscous_mu=2e4, viscous_tau=0.01
    )
    state = _squashed(state, scale=(1.2, 0.85))
    cfg = default_sim_config(auto_diff=False, use_explicit_method=True)
    obstacles = default_obstacles()
    sub_ref = make_substep_fn(obj, cfg)
    sub_diff = make_diff_substep_fn(obj, cfg)
    params = params_from_object(obj)
    s_ref, s_diff = state, state
    for _ in range(8):
        s_ref, _ = sub_ref(s_ref, obstacles)
        s_diff = sub_diff(params, s_diff, obstacles)
    np.testing.assert_allclose(
        np.asarray(s_diff.pos), np.asarray(s_ref.pos), atol=2e-5
    )
    np.testing.assert_allclose(
        np.asarray(s_diff.viscous_inv), np.asarray(s_ref.viscous_inv),
        atol=2e-5,
    )
