# coding=utf-8
"""Prescribed-motion Dirichlet pins (3-element ``pin_boxes`` entries) —
kinematic loading (stretch / compression / shear tests).  The reference has
no kinematic constraints at all; static pins were the round-4 `pin_boxes`
extension, and moving pins add the inhomogeneous projection
b̂ = P·(b − A·x_h) + x_h with particular solution x_h = (I−P)·v_pin."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from fem_tpu.models.mesh import construct_2d_mesh
from fem_tpu.models.state import Obstacles, build_object
from fem_tpu.sim import _cfg_kwargs, make_frame_fn, substep
from fem_tpu.utils.config import ObjectConfig, SimConfig, parse_config

V_PULL = 0.05  # prescribed upward speed of the top clamp


def _bar(subdivisions=5, v_pull=(0.0, V_PULL)):
    """Slab clamped at bottom (static pin) and top (moving pin)."""
    ocfg = ObjectConfig(
        center=(0.4, 0.4), side_length=0.2, subdivisions=subdivisions,
        E=2e4, nu=0.2, damping=5.0,
        pin_boxes=(
            ((0.0, 0.0), (1.0, 0.405)),                # bottom: static
            ((0.0, 0.595), (1.0, 1.0), tuple(v_pull)),  # top: moving
        ),
    )
    v, f, e = construct_2d_mesh(ocfg)
    obj, state = build_object(ocfg, v, f, e)
    top = np.asarray(state.pos)[:, 1] >= 0.595
    bottom = np.asarray(state.pos)[:, 1] <= 0.405
    return obj, state, top, bottom


def _cfg(**kw):
    base = dict(
        dim=2, delta_time=5e-4, sim_count=10, auto_diff=False,
        use_explicit_method=False, implicit_method=1, preconditioned=0,
        g_dir=(0.0, 0.0),
    )
    base.update(kw)
    return SimConfig(**base)


def test_config_parses_velocity_entries():
    cfg = parse_config(
        {
            "dim": 2,
            "objects": [
                {
                    "pin_boxes": [
                        [[0.0, 0.0], [1.0, 0.4]],
                        [[0.0, 0.6], [1.0, 1.0], [0.0, 0.05]],
                    ]
                }
            ],
        }
    )
    boxes = cfg.objects[0].pin_boxes
    assert len(boxes[0]) == 2 and len(boxes[1]) == 3
    assert boxes[1][2] == (0.0, 0.05)


def test_build_object_pin_vel_field():
    obj, state, top, bottom = _bar()
    pv = np.asarray(obj.pin_vel)
    assert np.allclose(pv[top], [0.0, V_PULL])
    assert np.allclose(pv[bottom], 0.0)
    free = np.asarray(obj.free_mask)[:, 0]
    assert (free[top] == 0.0).all() and (free[bottom] == 0.0).all()


@pytest.mark.parametrize(
    "method",
    ["explicit", "autodiff", "implicit", "implicit_pcg"],
)
def test_prescribed_motion_is_exact(method):
    """Pinned vertices move at EXACTLY the prescribed velocity on every
    integration path; static pins stay put; the bar stretches."""
    kw = dict(
        explicit=dict(use_explicit_method=True),
        autodiff=dict(use_explicit_method=False, auto_diff=True),
        implicit=dict(),
        implicit_pcg=dict(cg_precond="block_jacobi"),
    )[method]
    cfg = _cfg(**kw)
    obj, state, top, bottom = _bar()
    frame = make_frame_fn(obj, cfg)
    obs = Obstacles.from_configs((), 2)
    p0 = np.asarray(state.pos)
    n_frames = 40  # 0.2 virtual s
    s = state
    for _ in range(n_frames):
        s, _ = frame(s, obs)
        assert np.isfinite(np.asarray(s.pos)).all()
    p1 = np.asarray(s.pos)
    t_total = n_frames * cfg.sim_count * cfg.delta_time
    # Moving pins: displacement v·t, up to f32 per-substep rounding of the
    # position accumulation (400 substeps → ~1e-3 relative drift).
    np.testing.assert_allclose(
        p1[top] - p0[top],
        np.broadcast_to([0.0, V_PULL * t_total], p1[top].shape),
        rtol=0, atol=3e-5, err_msg=method,
    )
    # Static pins: bit-still.
    np.testing.assert_allclose(p1[bottom], p0[bottom], rtol=0, atol=1e-7)
    # Interior stretches toward the clamp (positive strain).
    interior = ~(top | bottom)
    assert (p1[interior, 1] - p0[interior, 1]).mean() > 0.2 * V_PULL * t_total


def test_stress_builds_up_under_stretch():
    from fem_tpu.ops.element import element_stresses, von_mises

    cfg = _cfg()
    obj, state, top, bottom = _bar()
    frame = make_frame_fn(obj, cfg)
    obs = Obstacles.from_configs((), 2)

    def max_vm(st):
        sig = element_stresses(
            st.pos, obj.element_indices, obj.ref_inv,
            obj.mu, obj.s_lambda, obj.material,
        )
        return float(jnp.max(von_mises(sig)))

    s = state
    vm0 = max_vm(s)
    for _ in range(60):
        s, _ = frame(s, obs)
    vm1 = max_vm(s)
    assert vm1 > vm0 + 10.0, (vm0, vm1)  # tension builds (Pa scale, E=2e4)


def test_implicit_matches_explicit_small_dt():
    """Implicit and explicit integrate the same constrained dynamics: at a
    small dt the trajectories agree closely through a stretch."""
    obj, state, top, bottom = _bar()
    obs = Obstacles.from_configs((), 2)
    cfg_i = _cfg(delta_time=1e-4, sim_count=20)
    cfg_e = _cfg(delta_time=1e-4, sim_count=20, use_explicit_method=True)
    s_i, s_e = state, state
    for _ in range(10):
        s_i, _ = make_frame_fn(obj, cfg_i)(s_i, obs)
        s_e, _ = make_frame_fn(obj, cfg_e)(s_e, obs)
    np.testing.assert_allclose(
        np.asarray(s_i.pos), np.asarray(s_e.pos), rtol=0, atol=2e-4
    )


def test_diff_substep_forward_parity_moving_pins():
    from fem_tpu.diff import make_diff_substep_fn, params_from_object

    obj, state, *_ = _bar()
    obs = Obstacles.from_configs((), 2)
    cfg = _cfg(
        sim_count=1, operator_mode="graph",
        cg_precond="none",
    )
    sub = make_diff_substep_fn(obj, cfg, n_cg_iters=120)
    s_diff = sub(params_from_object(obj), state, obs)
    s_ref, _ = substep(obj, state, obs, **_cfg_kwargs(cfg))
    # Fixed-iteration normal-equations CG vs the reference while_loop —
    # solver-tolerance agreement (documented diff.py deviation; same bound
    # as test_materials_implicit's diff parity).
    np.testing.assert_allclose(
        np.asarray(s_diff.vel), np.asarray(s_ref.vel), rtol=0, atol=5e-4
    )
    pv = np.asarray(obj.pin_vel)
    moving = np.abs(pv).sum(1) > 0
    # The prescribed pins themselves are EXACT on both paths.
    np.testing.assert_allclose(
        np.asarray(s_diff.vel)[moving], pv[moving], rtol=0, atol=1e-7
    )


def test_sharded_frame_moving_pins_matches_single_device():
    from fem_tpu.parallel.sharding import (
        make_element_mesh,
        make_sharded_frame_fn,
    )

    obj, state, *_ = _bar()
    obs = Obstacles.from_configs((), 2)
    cfg = _cfg(sim_count=2)
    mesh = make_element_mesh()
    s_sh, _ = make_sharded_frame_fn(obj, cfg, mesh)(state, obs)
    s_ref, _ = make_frame_fn(obj, cfg)(state, obs)
    np.testing.assert_allclose(
        np.asarray(s_sh.vel), np.asarray(s_ref.vel), rtol=0, atol=3e-5
    )
