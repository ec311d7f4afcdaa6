# coding=utf-8
"""Coulomb friction extensions (ObstacleConfig.friction /
SimConfig.wall_friction).

The reference's collisions are frictionless: sticky per-component wall
zeroing (solver/kinematic.py:25-30) and circle slide (kinematic.py:36-41).
The extension adds an impulse-level Coulomb cone on top of the same slide
structure: the removed normal speed |v_n| bounds the tangential speed
reduction by mu*|v_n|.  Physics pin: a body sliding on a frictional floor
decelerates at mu*g (the total normal impulse per unit time is the body's
weight), independent of contact area or stiffness.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from fem_tpu.models.state import Obstacles
from fem_tpu.sim import make_substep_fn
from fem_tpu.utils.config import ObstacleConfig, SimConfig
from tests.utils import make_2d_object


def _slide_com_decel(cfg, n_sub=500, vx0=2.0, warm=100, every=20):
    """COM tangential deceleration of a block sliding on the floor."""
    _, obj, state = make_2d_object(
        subdivisions=8, center=(0.2, cfg_floor_y(cfg)), side_length=0.2,
        damping=0.0,
    )
    state = state.replace(vel=state.vel.at[:, 0].set(vx0))
    obstacles = Obstacles.from_configs((), 2, cfg.obstacles)
    fn = make_substep_fn(obj, cfg)
    m = np.asarray(obj.mass)
    ts, vxs = [], []
    for i in range(n_sub):
        state, _ = fn(state, obstacles)
        if i >= warm and i % every == 0:
            v = np.asarray(state.vel)
            if state.vel_g is not None and not (
                cfg.use_explicit_method or cfg.auto_diff
            ):
                v = v + np.asarray(state.vel_g)
            vxs.append(float(m @ v[:, 0] / m.sum()))
            ts.append((i + 1) * cfg.delta_time)
    assert np.isfinite(np.asarray(state.pos)).all()
    return -np.polyfit(ts, vxs, 1)[0], vxs


def cfg_floor_y(cfg) -> float:
    """Floor height: the halfspace obstacle's y if present, else the y=0
    domain wall."""
    for o in cfg.obstacles:
        if o.type == "halfspace":
            return float(o.point[1])
    return 0.0


def _base_cfg(**kw):
    return SimConfig(
        dim=2, delta_time=5e-4, sim_count=10, auto_diff=False,
        use_explicit_method=True, implicit_method=1, preconditioned=0,
        g_dir=(0.0, -1.0), blocks=(), **kw,
    )


@pytest.mark.parametrize("mu", [0.3, 0.6])
def test_wall_friction_decelerates_at_mu_g(mu):
    decel, _ = _slide_com_decel(_base_cfg(wall_friction=mu))
    assert abs(decel - mu * 9.8) < 0.12 * mu * 9.8


def test_wall_friction_zero_is_parity():
    """mu = 0 compiles to the reference walls: the sliding block keeps its
    tangential speed bit-exactly, and the trajectory equals the default
    config's."""
    _, vxs0 = _slide_com_decel(_base_cfg(), n_sub=200)
    # f32 mass-weighted reduction rounds in the last ulp; momentum itself
    # is conserved (internal forces cancel, walls only zero y components).
    np.testing.assert_allclose(vxs0, 2.0, rtol=1e-6)
    assert vxs0[0] == vxs0[-1]


def test_halfspace_friction_explicit_and_implicit():
    obs = (ObstacleConfig(type="halfspace", point=(0.0, 0.3),
                          normal=(0.0, 1.0), friction=0.3),)
    import dataclasses

    for expl in (True, False):
        cfg = dataclasses.replace(
            _base_cfg(obstacles=obs), use_explicit_method=expl
        )
        decel, _ = _slide_com_decel(cfg)
        assert abs(decel - 0.3 * 9.8) < 0.12 * 0.3 * 9.8, (expl, decel)


def test_large_mu_sticks():
    """Above the Coulomb cone the contact layer sticks: the bottom row's
    tangential velocity collapses and the COM momentum decays."""
    cfg = _base_cfg(wall_friction=10.0)
    _, obj, state = make_2d_object(
        subdivisions=8, center=(0.2, 0.0), side_length=0.2, damping=0.0,
    )
    state = state.replace(vel=state.vel.at[:, 0].set(0.05))
    obstacles = Obstacles.from_configs((), 2)
    fn = make_substep_fn(obj, cfg)
    for _ in range(400):
        state, _ = fn(state, obstacles)
    m = np.asarray(obj.mass)
    v = np.asarray(state.vel)
    pos = np.asarray(state.pos)
    vx_com = float(m @ v[:, 0] / m.sum())
    assert vx_com < 0.03  # momentum draining (frictionless: constant 0.05)
    bottom = pos[:, 1] < 1e-3
    assert np.abs(v[bottom, 0]).max() < 0.02  # contact layer ~stuck


def test_frictional_sphere_routes_to_extension_path():
    """Spheres with friction stay off the reference circle arrays (which
    carry no per-obstacle friction) and still collide."""
    obs = (
        ObstacleConfig(type="sphere", center=(0.5, 0.5), radius=0.1,
                       friction=0.4),
        ObstacleConfig(type="sphere", center=(0.2, 0.2), radius=0.05),
    )
    o = Obstacles.from_configs((), 2, obs)
    assert o.sph_c is not None and o.sph_c.shape == (1, 2)
    assert o.sph_f == (0.4,)
    # The frictionless sphere folded into the reference circle arrays.
    assert float(o.radii.max()) == pytest.approx(0.05)
    # Slide semantics of the frictional sphere: a particle inside moving
    # inward loses its radial component (+ Coulomb tangential cut).
    from fem_tpu.obstacles import apply_extensions_explicit

    pos = jnp.array([[0.5, 0.42]])  # inside, below center
    v = jnp.array([[1.0, 1.0]])  # moving up (inward) and right
    v2 = np.asarray(apply_extensions_explicit(pos, v, o))
    assert v2[0, 1] < 1e-6  # radial (y) component removed
    assert 0.0 < v2[0, 0] < 1.0  # tangential reduced but not zeroed


def test_frictional_spheres_stay_on_extension_path():
    """A frictional sphere keeps its Coulomb coefficient on the SDF
    extension arrays; a frictionless one folds into the reference circle
    arrays (which carry no per-obstacle friction)."""
    from fem_tpu.obstacles import has_extensions

    def obstacles(friction):
        cfg = _base_cfg(obstacles=(
            ObstacleConfig(type="sphere", center=(0.5, 0.5), radius=0.1,
                           friction=friction),
        ))
        return Obstacles.from_configs(cfg.blocks, cfg.dim, cfg.obstacles)

    rough = obstacles(0.4)
    assert has_extensions(rough) and rough.sph_f == (0.4,)
    smooth = obstacles(0.0)
    assert not has_extensions(smooth)
    np.testing.assert_allclose(np.asarray(smooth.radii), [0.1])


def test_negative_friction_rejected():
    with pytest.raises(ValueError, match="friction"):
        Obstacles.from_configs(
            (), 2,
            (ObstacleConfig(type="halfspace", point=(0.0, 0.0),
                            normal=(0.0, 1.0), friction=-0.1),),
        )


def test_incline_stick_slip_threshold():
    """Tilted gravity on a frictional floor = the classic incline: the
    body slides iff tan(theta) > mu, and while sliding decelerates to
    a = g*(sin - mu*cos).  Exercises friction with a tangential gravity
    drive (non-trivial steady state) rather than an initial impulse."""
    theta = np.deg2rad(20.0)
    g_dir = (float(np.sin(theta)), -float(np.cos(theta)))
    obs = (ObstacleConfig(type="halfspace", point=(0.0, 0.2),
                          normal=(0.0, 1.0), friction=0.0),)

    def run(mu, n_sub=600):
        o = (ObstacleConfig(type="halfspace", point=(0.0, 0.2),
                            normal=(0.0, 1.0), friction=mu),)
        cfg = SimConfig(
            dim=2, delta_time=5e-4, sim_count=10, auto_diff=False,
            use_explicit_method=True, implicit_method=1, preconditioned=0,
            g_dir=g_dir, blocks=(), obstacles=o,
        )
        _, obj, state = make_2d_object(
            subdivisions=8, center=(0.2, 0.2), side_length=0.2, damping=0.0,
        )
        obstacles = Obstacles.from_configs((), 2, cfg.obstacles)
        fn = make_substep_fn(obj, cfg)
        m = np.asarray(obj.mass)
        x0 = float(m @ np.asarray(state.pos)[:, 0] / m.sum())
        ts, vxs = [], []
        for i in range(n_sub):
            state, _ = fn(state, obstacles)
            if i >= 200 and i % 20 == 0:
                v = np.asarray(state.vel)
                vxs.append(float(m @ v[:, 0] / m.sum()))
                ts.append((i + 1) * cfg.delta_time)
        x1 = float(m @ np.asarray(state.pos)[:, 0] / m.sum())
        return np.array(ts), np.array(vxs), x1 - x0

    # mu > tan(theta) = 0.364: sticks — the undamped body RINGS in shear
    # (vx oscillates around 0) but never drifts downhill.
    _, vx_stick, drift = run(0.6)
    assert abs(np.mean(vx_stick)) < 0.015
    # Net COM travel over 0.3 s: the first contact event slips before the
    # cone locks, so a few mm of transient creep is physical.
    assert abs(drift) < 0.008
    # mu < tan(theta): slides, accelerating at g*(sin - mu*cos).
    ts, vx_slip, drift_slip = run(0.2)
    a = np.polyfit(ts, vx_slip, 1)[0]
    a_expected = 9.8 * (np.sin(theta) - 0.2 * np.cos(theta))
    assert abs(a - a_expected) < 0.15 * a_expected
    assert drift_slip > 10 * abs(drift)
