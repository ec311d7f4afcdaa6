# coding=utf-8
"""Whole frames and advection of the plain-XLA main path against the
float64 oracle (tests/oracle.py), in 2D and 3D.

These cases took over the grid of the removed whole-frame and advection
kernel tests (dimension × method × inelastic layer): where those compared a
kernel with the op-composed frame, the frame itself is now compared with
the oracle's step semantics, walls and obstacle included.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from fem_tpu.models.mesh import construct_2d_mesh
from fem_tpu.models.state import Obstacles, SimState, build_object
from fem_tpu.ops import smallmat as sm
from fem_tpu.sim import make_frame_fn
from fem_tpu.solvers.advect import advect_implicit_step, kinematic_step
from fem_tpu.utils.config import BlockConfig, ObjectConfig, SimConfig
from tests.oracle import Oracle
from tests.utils import cube_tet_mesh

DT = 5e-4
DIMS = [2, 3]
SIM_COUNT = 4


def _scene(dim, **material):
    """(object config, object, state, obstacles, oracle blocks): a body
    resting its lower edge on the floor, squashed and kicked downward, with
    a circle/sphere obstacle over one upper corner — so walls, the obstacle
    and the elastic forces all act from the first substep."""
    if dim == 2:
        ocfg = ObjectConfig(subdivisions=4, side_length=0.3,
                            center=(0.35, 0.0), rho=1000.0, E=4e4, nu=0.3,
                            damping=10.0, **material)
        v, f, e = construct_2d_mesh(ocfg)
        obj, state = build_object(ocfg, v, f, e)
    else:
        nodes, f, tets = cube_tet_mesh(spacing=0.45)
        ocfg = ObjectConfig(obj="cube", center=(0.3, 0.0, 0.3), rho=1000.0,
                            E=4e4, nu=0.3, damping=10.0, **material)
        obj, state = build_object(
            ocfg, (nodes * 0.35).astype(np.float32), f, tets
        )
    rest = np.asarray(state.pos, np.float64)
    c = rest.mean(0, keepdims=True)
    pos = c + (rest - c) * np.array([1.08, 0.9, 1.05][:dim])
    pos[:, 1] -= pos[:, 1].min() + 0.002  # lowest layer below the floor
    vel = np.random.default_rng(dim).uniform(-0.3, 0.3, pos.shape)
    vel[:, 1] -= 0.5
    state = state.replace(pos=jnp.asarray(pos, jnp.float32),
                          vel=jnp.asarray(vel, jnp.float32))
    corner = tuple(float(x) for x in rest.max(0))
    blocks = [(corner, 0.3 * float(np.ptp(rest[:, 0])))]
    obstacles = Obstacles.from_configs(
        tuple(BlockConfig(block_center=c_, block_radius=r_)
              for c_, r_ in blocks), dim,
    )
    return ocfg, obj, state, obstacles, blocks


def _oracle(ocfg, obj, state):
    o = Oracle(np.asarray(obj.rest_pos, np.float64),
               np.asarray(obj.element_indices), ocfg.rho, ocfg.mu,
               ocfg.s_lambda, ocfg.damping)
    o.pos = np.asarray(state.pos, np.float64)
    o.vel = np.asarray(state.vel, np.float64)
    return o


METHODS = {
    # name: (config overrides, oracle step, position tolerance)
    "explicit": (dict(use_explicit_method=True), "explicit", 2e-4),
    "autodiff": (dict(use_explicit_method=True, auto_diff=True),
                 "explicit", 2e-4),
    "cg_precond": (dict(implicit_method=1, preconditioned=1), "cg", 5e-4),
    "cg_plain": (dict(implicit_method=1, preconditioned=0), "cg", 5e-4),
    "jacobi_serial": (dict(implicit_method=0, jacobi_sweep="serial"),
                      "jacobi", 5e-4),
    "jacobi_snapshot": (dict(implicit_method=0, jacobi_sweep="snapshot"),
                        "jacobi", 5e-4),
}


def _cfg(dim, **overrides):
    base = dict(
        dim=dim, delta_time=DT, sim_count=SIM_COUNT, auto_diff=False,
        use_explicit_method=False, implicit_method=1, preconditioned=1,
        g_dir=(0.0, -1.0, 0.0)[:dim], blocks=(),
    )
    base.update(overrides)
    return SimConfig(**base)


@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("method", list(METHODS))
def test_frame_matches_oracle(dim, method):
    over, kind, atol = METHODS[method]
    ocfg, obj, state, obstacles, blocks = _scene(dim)
    cfg = _cfg(dim, **over)
    oracle = _oracle(ocfg, obj, state)
    frame = make_frame_fn(obj, cfg)
    for _ in range(3):
        state, aux = frame(state, obstacles)
        for _ in range(SIM_COUNT):
            if kind == "explicit":
                oracle.step_explicit(DT, cfg.g_dir, blocks)
            elif kind == "cg":
                oracle.step_implicit_cg(DT, cfg.g_dir, blocks,
                                        cfg.preconditioned)
            else:
                oracle.step_implicit_jacobi(DT, cfg.g_dir, blocks,
                                            sweep=cfg.jacobi_sweep)
        np.testing.assert_allclose(np.asarray(state.pos), oracle.pos,
                                   atol=atol)
    assert np.asarray(aux.solver_iterations).shape == (SIM_COUNT,)


LAYERS = {
    "plastic": dict(plastic_yield=0.01),
    "viscous": dict(viscous_mu=2e4, viscous_tau=0.01),
    "both": dict(plastic_yield=0.01, viscous_mu=2e4, viscous_tau=0.01),
}


@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("layer", list(LAYERS))
def test_inelastic_frames_keep_invariants(dim, layer):
    """Implicit CG frames through a floor impact with each inelastic layer:
    the state stays finite, plastic flow happens and is isochoric
    (det F_p = 1), and the Maxwell branch strain moves."""
    ocfg, obj, state, obstacles, _ = _scene(dim, **LAYERS[layer])
    state = state.replace(vel=state.vel.at[:, 1].set(-4.0))
    frame = make_frame_fn(obj, _cfg(dim, preconditioned=0))
    for _ in range(10):
        state, _ = frame(state, obstacles)
    assert np.isfinite(np.asarray(state.pos)).all()
    eye = np.eye(dim)
    if state.plastic_inv is not None:
        fp = np.asarray(state.plastic_inv)
        assert np.abs(fp - eye).max() > 1e-3, "never yielded"
        np.testing.assert_allclose(np.asarray(sm.det(state.plastic_inv)),
                                   1.0, atol=1e-3)
    if state.viscous_inv is not None:
        fv = np.asarray(state.viscous_inv)
        assert np.isfinite(fv).all()
        assert np.abs(fv - eye).max() > 1e-4, "branch strain never moved"


@pytest.mark.parametrize("dim", DIMS)
def test_adaptive_frame_equals_plain_below_threshold(dim):
    """With κ far below threshold the per-frame guard takes the dt branch:
    the guarded frame equals the plain frame, one aux row per substep."""
    _, obj, state, obstacles, _ = _scene(dim)
    cfg = _cfg(dim, preconditioned=0)
    f_plain = make_frame_fn(obj, cfg)
    f_guard = make_frame_fn(obj, _cfg(dim, preconditioned=0,
                                      adaptive_dt=True))
    s_p, s_a = state, state
    for _ in range(3):
        s_p, aux_p = f_plain(s_p, obstacles)
        s_a, aux_a = f_guard(s_a, obstacles)
    np.testing.assert_allclose(np.asarray(s_a.pos), np.asarray(s_p.pos),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(aux_a.solver_iterations),
                                  np.asarray(aux_p.solver_iterations))
    assert aux_a.solver_iterations.shape == (SIM_COUNT,)


def _advect_case(dim, seed):
    """Particles scattered across the unit box and past its walls, with two
    obstacles, random velocities and forces."""
    rng = np.random.default_rng(seed)
    n = 200
    pos = rng.uniform(-0.05, 1.05, (n, dim))
    vel = rng.uniform(-1.0, 1.0, (n, dim))
    blocks = [((0.3,) * dim, 0.2), ((0.7,) + (0.6,) * (dim - 1), 0.15)]
    obstacles = Obstacles.from_configs(
        tuple(BlockConfig(block_center=c, block_radius=r)
              for c, r in blocks), dim,
    )
    return rng, pos, vel, blocks, obstacles


def _bare_oracle(pos, vel, mass, damping):
    o = Oracle.__new__(Oracle)
    o.d, o.n, o.damping = pos.shape[1], pos.shape[0], damping
    o.pos, o.vel, o.mass = pos.copy(), vel.copy(), mass.copy()
    return o


@pytest.mark.parametrize("dim", DIMS)
def test_kinematic_matches_oracle(dim):
    rng, pos, vel, blocks, obstacles = _advect_case(dim, 10 + dim)
    grad = rng.standard_normal(pos.shape)
    mass = rng.uniform(0.5, 2.0, pos.shape[0])
    g_dir = (0.0, -1.0, 0.0)[:dim]
    zeros = jnp.zeros(pos.shape, jnp.float32)
    state = SimState(pos=jnp.asarray(pos, jnp.float32),
                     vel=jnp.asarray(vel, jnp.float32), vel_g=zeros,
                     force=zeros, jacobi_past_x=zeros)
    out = kinematic_step(state, jnp.asarray(grad, jnp.float32),
                         jnp.asarray(mass, jnp.float32), obstacles, DT,
                         10.0, g_dir)
    o = _bare_oracle(np.asarray(state.pos, np.float64),
                     np.asarray(state.vel, np.float64), mass, 10.0)
    o.kinematic(np.asarray(grad, np.float32).astype(np.float64), DT, g_dir,
                blocks)
    np.testing.assert_allclose(np.asarray(out.vel), o.vel, atol=1e-5)
    np.testing.assert_allclose(np.asarray(out.pos), o.pos, atol=1e-6)


@pytest.mark.parametrize("dim", DIMS)
def test_advect_implicit_matches_oracle(dim):
    rng, pos, vel, blocks, obstacles = _advect_case(dim, 20 + dim)
    vel_g = rng.uniform(-1.0, 1.0, pos.shape)
    g_dir = (0.0, -1.0, 0.0)[:dim]
    zeros = jnp.zeros(pos.shape, jnp.float32)
    state = SimState(pos=jnp.asarray(pos, jnp.float32),
                     vel=jnp.asarray(vel, jnp.float32),
                     vel_g=jnp.asarray(vel_g, jnp.float32), force=zeros,
                     jacobi_past_x=zeros)
    out = advect_implicit_step(state, obstacles, DT, 10.0, g_dir)
    o = _bare_oracle(np.asarray(state.pos, np.float64),
                     np.asarray(state.vel, np.float64),
                     np.ones(pos.shape[0]), 10.0)
    o.vel_g = np.asarray(state.vel_g, np.float64)
    o.advect_implicit(DT, g_dir, blocks)
    np.testing.assert_allclose(np.asarray(out.vel), o.vel, atol=1e-5)
    np.testing.assert_allclose(np.asarray(out.vel_g), o.vel_g, atol=1e-5)
    np.testing.assert_allclose(np.asarray(out.pos), o.pos, atol=1e-6)
