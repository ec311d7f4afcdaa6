# coding=utf-8
"""Neumann loads (``ObjectConfig.load_boxes``) — framework extension (the
reference's only external action is gravity).  A load box distributes a
TOTAL force vector over the vertices whose initial position falls in the
box, mass-weighted (refinement-independent).  Applied on every integration
path (explicit / autodiff / implicit via the rhs fold), in the
differentiable substeps, under sharding, and inside solve_static."""

import jax.numpy as jnp
import numpy as np
import pytest

from fem_tpu.models.mesh import construct_2d_mesh
from fem_tpu.models.state import Obstacles, build_object
from fem_tpu.sim import _cfg_kwargs, make_frame_fn, make_substep_fn, substep
from fem_tpu.utils.config import ObjectConfig, SimConfig, parse_config


def _loaded_object(subdivisions=4, f_total=(0.5, 0.0), **kw):
    ocfg = ObjectConfig(
        center=(0.5, 0.5), side_length=0.2, subdivisions=subdivisions,
        load_boxes=(((0.0, 0.0), (1.0, 1.0), tuple(f_total)),), **kw
    )
    v, f, e = construct_2d_mesh(ocfg)
    return build_object(ocfg, v, f, e)


def _cfg(**kw):
    base = dict(
        dim=2, delta_time=5e-4, sim_count=1, auto_diff=False,
        use_explicit_method=True, g_dir=(0.0, 0.0),
    )
    base.update(kw)
    return SimConfig(**base)


def test_load_box_builds_mass_weighted_total():
    obj, _ = _loaded_object(f_total=(0.5, -0.25))
    load = np.asarray(obj.static_load)
    np.testing.assert_allclose(load.sum(0), [0.5, -0.25], rtol=1e-6)
    # Mass-weighted: load_i ∝ m_i.
    m = np.asarray(obj.mass)
    np.testing.assert_allclose(
        load[:, 0], 0.5 * m / m.sum(), rtol=1e-5
    )


def test_load_box_selecting_nothing_raises():
    ocfg = ObjectConfig(
        center=(0.5, 0.5), side_length=0.2, subdivisions=3,
        load_boxes=(((9.0, 9.0), (9.1, 9.1), (1.0, 0.0)),),
    )
    v, f, e = construct_2d_mesh(ocfg)
    with pytest.raises(ValueError, match="selects no vertices"):
        build_object(ocfg, v, f, e)


def test_config_json_roundtrip():
    cfg = parse_config(
        {
            "dim": 2,
            "objects": [
                {
                    "load_boxes": [[[0.0, 0.0], [1.0, 1.0], [0.5, 0.0]]],
                }
            ],
        }
    )
    assert cfg.objects[0].load_boxes == (((0.0, 0.0), (1.0, 1.0), (0.5, 0.0)),)


@pytest.mark.parametrize(
    "method",
    ["explicit", "autodiff", "implicit"],
)
def test_momentum_rate_equals_total_force(method):
    """One substep from rest, zero gravity: Δ(Σ m v) = dt · F_total on every
    integration path."""
    obj, state = _loaded_object(f_total=(0.5, 0.2))
    kw = dict(
        explicit=dict(use_explicit_method=True, auto_diff=False),
        autodiff=dict(use_explicit_method=False, auto_diff=True),
        implicit=dict(
            use_explicit_method=False, auto_diff=False,
            implicit_method=1, preconditioned=0,
        ),
    )[method]
    cfg = _cfg(**kw)
    obs = Obstacles.from_configs((), 2)
    s, _ = substep(obj, state, obs, **_cfg_kwargs(cfg))
    dp = (np.asarray(obj.mass)[:, None] * np.asarray(s.vel)).sum(0)
    np.testing.assert_allclose(
        dp, [5e-4 * 0.5, 5e-4 * 0.2], rtol=0.02, err_msg=method
    )


def test_diff_substep_forward_parity_with_load():
    """The differentiable substeps see obj.static_load (forward parity with
    the non-diff path — the silent-drop failure class of ADVICE r3)."""
    from fem_tpu.diff import make_diff_substep_fn, params_from_object

    obj, state = _loaded_object()
    obs = Obstacles.from_configs((), 2)
    for kw in (
        dict(use_explicit_method=True, auto_diff=False),
        dict(
            use_explicit_method=False, auto_diff=False,
            implicit_method=1, preconditioned=0, cg_precond="none",
        ),
    ):
        cfg = _cfg(operator_mode="graph", **kw)
        sub = make_diff_substep_fn(obj, cfg, n_cg_iters=60)
        s_diff = sub(params_from_object(obj), state, obs)
        s_ref, _ = substep(obj, state, obs, **_cfg_kwargs(cfg))
        np.testing.assert_allclose(
            np.asarray(s_diff.vel), np.asarray(s_ref.vel),
            rtol=0, atol=2e-5, err_msg=str(kw),
        )


def test_static_equilibrium_includes_load():
    """Pinned slab with a sideways tip load: solve_static equilibrium
    displaces in the load direction, and scales down when the load does."""
    from fem_tpu.solvers.static import solve_static

    def solve(fx):
        ocfg = ObjectConfig(
            center=(0.5, 0.5), side_length=0.2, subdivisions=5,
            E=2e4, nu=0.2,
            pin_boxes=(((0.0, 0.695), (1.0, 1.0)),),
            load_boxes=(((0.0, 0.0), (1.0, 0.505), (fx, 0.0)),),
        )
        v, f, e = construct_2d_mesh(ocfg)
        obj, state = build_object(ocfg, v, f, e)
        res = solve_static(obj, state.pos, g_dir=None)
        return np.asarray(res.pos) - np.asarray(state.pos)

    disp_big = solve(2.0)
    disp_small = solve(0.5)
    assert disp_big[:, 0].max() > 3e-4  # deflects toward +x
    # Near-linear regime: 4x the load ≈ 4x the tip deflection (loose).
    ratio = disp_big[:, 0].max() / disp_small[:, 0].max()
    assert 2.5 < ratio < 5.5, ratio


def test_frame_fn_with_load_matches_graph_reference():
    """make_frame_fn honors loads: one frame (a lax.scan over sim_count
    substeps) matches the same number of single compiled substeps."""
    obj, state = _loaded_object(f_total=(0.3, 0.1))
    obs = Obstacles.from_configs((), 2)
    cfg_auto = _cfg(
        sim_count=4, use_explicit_method=False, auto_diff=False,
        implicit_method=1, preconditioned=0,
    )
    s_a, _ = make_frame_fn(obj, cfg_auto)(state, obs)
    step = make_substep_fn(obj, cfg_auto)
    s_g = state
    for _ in range(cfg_auto.sim_count):
        s_g, _ = step(s_g, obs)
    np.testing.assert_allclose(
        np.asarray(s_a.vel), np.asarray(s_g.vel), rtol=0, atol=2e-5
    )
    assert float(jnp.abs(s_a.vel).max()) > 0.0


def test_sharded_frame_with_load_matches_single_device():
    from fem_tpu.parallel.sharding import (
        make_element_mesh,
        make_sharded_frame_fn,
    )

    obj, state = _loaded_object(f_total=(0.4, -0.1))
    obs = Obstacles.from_configs((), 2)
    cfg = _cfg(
        sim_count=2, use_explicit_method=False, auto_diff=False,
        implicit_method=1, preconditioned=0,
    )
    mesh = make_element_mesh()
    s_sh, _ = make_sharded_frame_fn(obj, cfg, mesh)(state, obs)
    s_ref, _ = make_frame_fn(obj, cfg)(state, obs)
    np.testing.assert_allclose(
        np.asarray(s_sh.vel), np.asarray(s_ref.vel), rtol=0, atol=3e-5
    )
