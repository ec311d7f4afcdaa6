# coding=utf-8
"""Dirichlet boundary conditions (``ObjectConfig.pin_boxes`` extension).

The reference has no kinematic constraints at all — its only boundary
handling is the sticky unit-box walls (solver/kinematic.py:25-30).  Pinned
vertices are held exactly: zero velocity, constant position; the implicit
system is solved with the standard projection P·A·P + (I−P) wrapped around
the matrix-free operator (solvers/implicit._cg_solve_dispatch).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fem_tpu.models.state import Obstacles, build_object, dense_system_matrix
from fem_tpu.sim import make_substep_fn, substep
from fem_tpu.solvers.implicit import implicit_rhs
from fem_tpu.utils.config import ObjectConfig, SimConfig, parse_config
from tests.utils import attach_edge_matrix, make_2d_object, make_3d_object

G_DIR = (0.0, -1.0)


def pinned_2d(**mat):
    """5x5 grid at center (0.4, 0.5); the top row (y = 0.7) pinned."""
    return make_2d_object(
        subdivisions=4, center=(0.4, 0.5),
        pin_boxes=(((0.35, 0.695), (0.65, 0.705)),), **mat
    )


def no_obstacles(dim=2):
    return Obstacles(
        centers=jnp.zeros((1, dim), jnp.float32),
        radii=jnp.zeros((1,), jnp.float32),
    )


def test_free_mask_built_from_pin_boxes():
    _, obj, state = pinned_2d()
    assert obj.free_mask is not None
    mask = np.asarray(obj.free_mask)[:, 0]
    pos = np.asarray(state.pos)
    top = pos[:, 1] > 0.699
    assert top.sum() == 5  # 5x5 grid top row
    np.testing.assert_array_equal(mask[top], 0.0)
    np.testing.assert_array_equal(mask[~top], 1.0)


def test_no_pin_boxes_means_no_mask():
    _, obj, _ = make_2d_object()
    assert obj.free_mask is None


def test_config_parse_pin_boxes():
    cfg = parse_config(
        {
            "dim": 2,
            "objects": [
                {"pin_boxes": [[[0.0, 0.9], [1.0, 1.1]]]},
            ],
        }
    )
    assert cfg.objects[0].pin_boxes == (((0.0, 0.9), (1.0, 1.1)),)


def _run(cfg_kwargs, obj, state, steps=60):
    cfg = SimConfig(dim=obj.dim, g_dir=G_DIR[: obj.dim] if obj.dim == 2
                    else (0.0, -1.0, 0.0), **cfg_kwargs)
    step = make_substep_fn(obj, cfg)
    obs = no_obstacles(obj.dim)
    for _ in range(steps):
        state, _ = step(state, obs)
    return state


@pytest.mark.parametrize(
    "cfg_kwargs",
    [
        dict(use_explicit_method=True, auto_diff=False),
        dict(use_explicit_method=True, auto_diff=True),
        dict(use_explicit_method=False, auto_diff=False, implicit_method=1),
        dict(use_explicit_method=False, auto_diff=False, implicit_method=1,
             cg_precond="none"),
        dict(use_explicit_method=False, auto_diff=False, implicit_method=1,
             cg_precond="block_jacobi"),
        dict(use_explicit_method=False, auto_diff=False, implicit_method=1,
             hessian="exact_jvp", cg_precond="none"),
    ],
)
def test_pinned_vertices_hold(cfg_kwargs):
    _, obj, state = pinned_2d()
    pos0 = np.asarray(state.pos).copy()
    pinned = np.asarray(obj.free_mask)[:, 0] == 0.0
    out = _run(cfg_kwargs, obj, state)
    pos = np.asarray(out.pos)
    vel = np.asarray(out.vel)
    assert np.all(np.isfinite(pos))
    np.testing.assert_array_equal(pos[pinned], pos0[pinned])
    np.testing.assert_array_equal(vel[pinned], 0.0)
    # free vertices sag under gravity
    assert pos[~pinned, 1].mean() < pos0[~pinned, 1].mean() - 1e-5


def test_pinned_implicit_3d_mxu_operator():
    """Dirichlet projection around the dense edge-matrix operator (3D)."""
    _, obj, state = make_3d_object(
        subdivisions=3, center=(0.4, 0.6, 0.4),
        pin_boxes=(((0.3, 0.795, 0.3), (0.7, 0.805, 0.7)),),
    )
    assert obj.free_mask is not None
    obj = attach_edge_matrix(obj)
    pinned = np.asarray(obj.free_mask)[:, 0] == 0.0
    assert pinned.sum() > 0
    pos0 = np.asarray(state.pos).copy()
    cfg = SimConfig(
        dim=3, g_dir=(0.0, -1.0, 0.0), use_explicit_method=False,
        implicit_method=1, operator_mode="mxu",
    )
    step = make_substep_fn(obj, cfg)
    obs = no_obstacles(3)
    for _ in range(40):
        state, _ = step(state, obs)
    pos = np.asarray(state.pos)
    assert np.all(np.isfinite(pos))
    np.testing.assert_array_equal(pos[pinned], pos0[pinned])
    assert pos[~pinned, 1].mean() < pos0[~pinned, 1].mean() - 1e-5


def test_projected_solve_matches_dense_constrained_solve():
    """The matrix-free projected CG solution equals the dense solve of
    (P·A·P + I−P)·x = P·b, and satisfies x = 0 on pinned rows exactly."""
    _, obj, state = pinned_2d()
    dt = 5e-4
    # one gravity kick so b is nontrivial
    state = state.replace(vel=state.vel - 0.3)
    from fem_tpu.solvers.implicit import implicit_velocity_solve

    solved, _ = implicit_velocity_solve(
        obj, state, dt, method=1, preconditioned=0, cg_precond="none",
    )
    x = np.asarray(solved.vel, np.float64)
    free = np.asarray(obj.free_mask)[:, 0]
    n, d = x.shape
    a = dense_system_matrix(obj, state, dt)
    p = np.repeat(free, d)
    proj = np.diag(p)
    a_hat = proj @ a @ proj + np.diag(1.0 - p)
    b = np.asarray(implicit_rhs(obj, state, dt), np.float64).reshape(-1) * p
    x_ref = np.linalg.solve(a_hat, b).reshape(n, d)
    np.testing.assert_array_equal(x[free == 0.0], 0.0)
    np.testing.assert_allclose(x, x_ref, atol=5e-4)


def test_pcg_matches_plain_cg_with_pins():
    _, obj, state = pinned_2d()
    dt = 5e-4
    state = state.replace(vel=state.vel - 0.3)
    from fem_tpu.solvers.implicit import implicit_velocity_solve

    plain, _ = implicit_velocity_solve(
        obj, state, dt, method=1, preconditioned=0, cg_precond="none",
    )
    pcg, _ = implicit_velocity_solve(
        obj, state, dt, method=1, preconditioned=0, cg_precond="block_jacobi",
    )
    np.testing.assert_allclose(
        np.asarray(plain.vel), np.asarray(pcg.vel), atol=2e-4
    )


def test_jacobi_with_pins_raises():
    _, obj, state = pinned_2d()
    with pytest.raises(ValueError, match="pin_boxes"):
        substep(
            obj, state, no_obstacles(2), dt=5e-4, g_dir=G_DIR,
            use_explicit_method=False, auto_diff=False, implicit_method=0,
            preconditioned=0,
        )


def test_hanging_bar_settles_to_rest():
    """Pinned-top bar under gravity: kinetic energy decays toward zero and
    the equilibrium sags below the rest height — the classic hanging-bar
    sanity case the reference cannot express."""
    _, obj, state = pinned_2d(E=2e4, damping=40.0)
    cfg = SimConfig(
        dim=2, g_dir=G_DIR, use_explicit_method=False, implicit_method=1,
        cg_precond="none", sim_count=10,
    )
    from fem_tpu.sim import make_frame_fn

    frame = make_frame_fn(obj, cfg)
    obs = no_obstacles(2)
    for _ in range(80):
        state, _ = frame(state, obs)
    # At rest the implicit channels cancel: vel ≈ −vel_g (gravity lives in
    # vel_g, reference implicit.py:409); the physical velocity is their sum.
    vel = np.asarray(state.vel + state.vel_g)
    pos = np.asarray(state.pos)
    assert np.all(np.isfinite(pos))
    assert np.abs(vel).max() < 5e-3  # settled
    free = np.asarray(obj.free_mask)[:, 0] == 1.0
    rest = np.asarray(obj.rest_pos)
    assert pos[free, 1].mean() < rest[free, 1].mean() - 1e-4  # sagged


def test_sharded_pinned_matches_single_chip():
    from fem_tpu.parallel.sharding import (
        make_element_mesh, make_sharded_substep_fn,
    )

    if len(jax.devices()) < 2:
        pytest.skip("needs multiple devices")
    _, obj, state = pinned_2d()
    cfg = SimConfig(
        dim=2, g_dir=G_DIR, use_explicit_method=False, implicit_method=1,
        cg_precond="none",
    )
    mesh = make_element_mesh(2)
    sharded = make_sharded_substep_fn(obj, cfg, mesh)
    single = make_substep_fn(obj, cfg)
    obs = no_obstacles(2)
    s_sh, s_si = state, state
    for _ in range(5):
        s_sh, _ = sharded(s_sh, obs)
        s_si, _ = single(s_si, obs)
    np.testing.assert_allclose(
        np.asarray(s_sh.pos), np.asarray(s_si.pos), atol=1e-6
    )
    pinned = np.asarray(obj.free_mask)[:, 0] == 0.0
    np.testing.assert_array_equal(
        np.asarray(s_sh.pos)[pinned], np.asarray(state.pos)[pinned]
    )


def test_diff_substep_respects_pins():
    from fem_tpu.diff import DiffParams, make_diff_substep_fn

    cfg_o, obj, state = pinned_2d()
    cfg = SimConfig(
        dim=2, g_dir=G_DIR, use_explicit_method=False, implicit_method=1,
        objects=(cfg_o,),
    )
    sub = make_diff_substep_fn(obj, cfg)
    params = DiffParams(
        mu=jnp.float32(cfg_o.mu), s_lambda=jnp.float32(cfg_o.s_lambda),
        damping=jnp.float32(cfg_o.damping),
    )
    obs = no_obstacles(2)
    s = state
    for _ in range(20):
        s = sub(params, s, obs)
    pinned = np.asarray(obj.free_mask)[:, 0] == 0.0
    np.testing.assert_array_equal(
        np.asarray(s.pos)[pinned], np.asarray(state.pos)[pinned]
    )
    np.testing.assert_array_equal(np.asarray(s.vel)[pinned], 0.0)
    assert np.asarray(s.pos)[~pinned, 1].mean() < np.asarray(state.pos)[
        ~pinned, 1
    ].mean()
