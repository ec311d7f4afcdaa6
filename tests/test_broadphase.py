# coding=utf-8
"""Uniform-grid contact broad phase (fem_tpu/broadphase.py) vs the dense
pair machinery (fem_tpu/contact.py).

Correctness anchor: with cell size = contact radius, every pair within
the radius lies in adjacent cells, so when no cell overflows the cap the
grid finds EXACTLY the dense pair set — forces must agree to f32
rounding.  Momentum is exact by construction (each found ordered pair
scatters +f/2 and −f/2), even under forced cap truncation.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from fem_tpu.broadphase import (
    grid_contact_forces,
    grid_overflow_count,
    grid_shape,
)
from fem_tpu.contact import pair_contact_forces, self_contact_forces


def _two_clouds(seed=0, na=60, nb=50, d=2):
    rng = np.random.default_rng(seed)
    a = (0.3 + 0.25 * rng.random((na, d))).astype(np.float32)
    b = (0.45 + 0.25 * rng.random((nb, d))).astype(np.float32)
    return jnp.asarray(a), jnp.asarray(b)


@pytest.mark.parametrize("d", [2, 3])
def test_grid_matches_dense_two_bodies(d):
    pos_a, pos_b = _two_clouds(d=d)
    radius, k = 0.06, 1e3
    rng = np.random.default_rng(1)
    vel_a = jnp.asarray(rng.standard_normal(pos_a.shape), jnp.float32)
    vel_b = jnp.asarray(rng.standard_normal(pos_b.shape), jnp.float32)
    f_a, f_b = pair_contact_forces(
        pos_a, pos_b, radius, k, vel_a, vel_b, friction_c=2.0
    )
    pos = jnp.concatenate([pos_a, pos_b])
    vel = jnp.concatenate([vel_a, vel_b])
    body = jnp.concatenate([
        jnp.zeros(pos_a.shape[0], jnp.int32),
        jnp.ones(pos_b.shape[0], jnp.int32),
    ])
    assert grid_overflow_count(np.asarray(pos), radius, cap=8) == 0
    f = grid_contact_forces(
        pos, body, pos, radius, k, vel=vel, friction_c=2.0, cap=8
    )
    # The dense path computes distances via ‖a‖²+‖b‖²−2ab, which cancels
    # catastrophically in pen = radius − dist near the contact boundary
    # (measured ~3e-4·scale vs an f64 oracle); the grid's direct
    # difference is ~20× tighter (~1e-5·scale).  Compare at the dense
    # path's own error level.
    scale = float(jnp.abs(f_a).max()) + 1e-9
    np.testing.assert_allclose(
        np.asarray(f[:pos_a.shape[0]]), np.asarray(f_a),
        atol=1e-3 * scale, rtol=0,
    )
    np.testing.assert_allclose(
        np.asarray(f[pos_a.shape[0]:]), np.asarray(f_b),
        atol=1e-3 * scale, rtol=0,
    )


def test_grid_tighter_than_dense_vs_f64_oracle():
    """The grid formulation is the MORE accurate one: direct coordinate
    differences instead of the dense path's cancelling ‖a‖²+‖b‖²−2ab."""
    pos_a, pos_b = _two_clouds(d=2)
    radius, k = 0.06, 1e3
    pos64 = np.concatenate(
        [np.asarray(pos_a), np.asarray(pos_b)]
    ).astype(np.float64)
    body = np.concatenate(
        [np.zeros(pos_a.shape[0], np.int32),
         np.ones(pos_b.shape[0], np.int32)]
    )
    f64 = np.zeros_like(pos64)
    for i in range(pos64.shape[0]):
        for j in range(pos64.shape[0]):
            if i == j or body[i] == body[j]:
                continue
            dvec = pos64[i] - pos64[j]
            dist = np.linalg.norm(dvec)
            pen = max(radius - dist, 0.0)
            if pen > 0.0:
                f64[i] += k * pen / max(dist, 0.1 * radius) * dvec
    f_a, f_b = pair_contact_forces(pos_a, pos_b, radius, k)
    fd = np.concatenate([np.asarray(f_a), np.asarray(f_b)])
    fg = np.asarray(grid_contact_forces(
        jnp.asarray(pos64.astype(np.float32)), jnp.asarray(body),
        jnp.asarray(pos64.astype(np.float32)), radius, k, cap=8,
    ))
    err_dense = np.abs(fd - f64).max()
    err_grid = np.abs(fg - f64).max()
    assert err_grid < 1e-4 * np.abs(f64).max()
    assert err_grid < 0.1 * err_dense


def test_grid_matches_dense_self_contact():
    """A bent 2D strip: rest positions exclude neighbors, deformed
    positions fold distant rest regions together."""
    n = 80
    t = np.linspace(0.0, 1.0, n, dtype=np.float32)
    rest = np.stack([0.05 + 0.9 * t, 0.5 * np.ones_like(t)], 1)
    # Bend into a near-full circle: the strip's ENDS (rest distance 0.9)
    # come within ~0.04 of each other.
    ang = 1.95 * np.pi * t
    bent = np.stack(
        [0.3 + 0.25 * np.sin(ang), 0.5 + 0.25 * (1 - np.cos(ang))], 1
    ).astype(np.float32)
    radius, k = 0.05, 1e3
    excl = 2.5 * radius
    d_rest = np.linalg.norm(rest[:, None] - rest[None, :], axis=-1)
    mask = jnp.asarray((d_rest > excl).astype(np.float32))
    f_dense = self_contact_forces(jnp.asarray(bent), mask, radius, k)
    assert grid_overflow_count(bent, radius, cap=16) == 0
    f_grid = grid_contact_forces(
        jnp.asarray(bent), jnp.zeros(n, jnp.int32), jnp.asarray(rest),
        radius, k, cap=16, self_contact=True,
    )
    assert float(jnp.abs(f_dense).max()) > 0.0  # the fold actually touches
    scale = float(jnp.abs(f_dense).max())
    np.testing.assert_allclose(
        np.asarray(f_grid), np.asarray(f_dense), atol=1e-3 * scale,
        rtol=0,
    )


def test_grid_momentum_exact_under_truncation():
    """cap=1 forcibly truncates candidate lists — forces weaken but the
    total must still vanish (each found pair scatters +f/2 / −f/2)."""
    rng = np.random.default_rng(2)
    pos = jnp.asarray(
        (0.45 + 0.1 * rng.random((200, 3))).astype(np.float32)
    )
    body = jnp.asarray((rng.random(200) < 0.5).astype(np.int32))
    radius = 0.08
    assert grid_overflow_count(np.asarray(pos), radius, cap=1) > 0
    f = grid_contact_forces(pos, body, pos, radius, 1e3, cap=1)
    assert float(jnp.abs(f).max()) > 0.0
    total = np.asarray(jnp.sum(f, axis=0))
    np.testing.assert_allclose(
        total, 0.0, atol=1e-4 * float(jnp.abs(f).max())
    )


def test_grid_no_wraparound_ghost_forces():
    """Vertices at opposite domain edges share no force even though edge
    neighbor-cell ids can wrap across grid rows (the distance test must
    kill those candidates)."""
    pos = jnp.asarray(
        [[0.5, 0.001], [0.5, 0.999], [0.001, 0.5], [0.999, 0.5]],
        jnp.float32,
    )
    body = jnp.asarray([0, 1, 0, 1], jnp.int32)
    f = grid_contact_forces(pos, body, pos, 0.05, 1e3, cap=8)
    np.testing.assert_array_equal(np.asarray(f), 0.0)


def test_grid_shape_guard():
    with pytest.raises(ValueError, match="too small"):
        grid_shape(1e-4, 3)
    m, _ = grid_shape(0.05, 3)
    assert m == 22


def test_contact_frame_grid_matches_dense_trajectory():
    """End-to-end: the two-body drop advanced with contact_broadphase
    'grid' tracks the 'dense' trajectory (identical pair set, f32-level
    force differences only)."""
    from fem_tpu.contact import make_contact_frame_fn
    from fem_tpu.models.mesh import construct_2d_mesh
    from fem_tpu.models.state import Obstacles, build_object
    from fem_tpu.utils.config import ObjectConfig, SimConfig

    objs_cfg = (
        ObjectConfig(center=(0.4, 0.25), side_length=0.2, subdivisions=6,
                     E=4e4),
        ObjectConfig(center=(0.42, 0.55), side_length=0.2, subdivisions=6),
    )
    outs = {}
    for mode in ("dense", "grid"):
        cfg = SimConfig(
            dim=2, delta_time=5e-4, sim_count=5, auto_diff=False,
            use_explicit_method=True, implicit_method=1, preconditioned=0,
            g_dir=(0.0, -1.0), blocks=(), objects=objs_cfg,
            contact="penalty", contact_broadphase=mode,
        )
        scene = []
        for oc in objs_cfg:
            v, fc, el = construct_2d_mesh(oc)
            scene.append(build_object(oc, v, fc, el))
        objs = [s[0] for s in scene]
        states = tuple(s[1] for s in scene)
        frame = make_contact_frame_fn(objs, cfg)
        obstacles = Obstacles.from_configs((), 2)
        for _ in range(20):
            states, _ = frame(states, obstacles)
        outs[mode] = [np.asarray(s.pos) for s in states]
    for pa, pb in zip(outs["dense"], outs["grid"]):
        assert np.isfinite(pb).all()
        np.testing.assert_allclose(pa, pb, atol=2e-4)


def test_auto_mode_threshold():
    from fem_tpu.contact import build_contact_plan
    from fem_tpu.models.mesh import construct_2d_mesh
    from fem_tpu.models.state import build_object
    from fem_tpu.utils.config import ObjectConfig, SimConfig

    oc = ObjectConfig(center=(0.4, 0.4), side_length=0.2, subdivisions=6)
    v, fc, el = construct_2d_mesh(oc)
    obj, _ = build_object(oc, v, fc, el)
    base = dict(
        dim=2, delta_time=5e-4, sim_count=5, auto_diff=False,
        use_explicit_method=True, implicit_method=1, preconditioned=0,
        g_dir=(0.0, -1.0), blocks=(), contact="penalty",
    )
    plan = build_contact_plan([obj, obj], SimConfig(**base), 0.03)
    assert plan.mode == "dense"  # 2·49 vertices, far under threshold
    plan_g = build_contact_plan(
        [obj, obj],
        SimConfig(contact_broadphase="grid", **base), 0.03,
    )
    assert plan_g.mode == "grid"
    assert plan_g.body_id.shape[0] == sum(plan_g.sizes)


def test_coulomb_pair_friction_block_on_slab():
    """contact_mu (grid-only Coulomb pair friction): a block sliding on a
    pinned slab decelerates at the order of mu*g.  The exact rigid-body
    mu*g is an upper bound: the deformable contact layer partially STICKS
    (measured: mean tangential ~ half the cone bound, and raising mu
    beyond that changes nothing), so the COM decelerates at what the
    body's shear can transmit — real stick-slip, pinned as a band."""
    from fem_tpu.contact import make_contact_frame_fn
    from fem_tpu.models.mesh import construct_2d_mesh
    from fem_tpu.models.state import Obstacles, build_object
    from fem_tpu.utils.config import ObjectConfig, SimConfig

    def run(mu):
        objs_cfg = (
            ObjectConfig(center=(0.0, 0.0), side_length=0.6,
                         subdivisions=12, E=1e5, damping=0.0,
                         pin_boxes=(((-1.0, -0.1), (2.0, 0.06)),)),
            ObjectConfig(center=(0.05, 0.615), side_length=0.15,
                         subdivisions=6, E=1e5, damping=0.0),
        )
        cfg = SimConfig(
            dim=2, delta_time=5e-4, sim_count=5, auto_diff=False,
            use_explicit_method=True, implicit_method=1, preconditioned=0,
            g_dir=(0.0, -1.0), blocks=(), objects=objs_cfg,
            contact="penalty", contact_mu=mu, contact_broadphase="grid",
            contact_friction=0.3,  # small normal dashpot kills the bounce
        )
        scene = [build_object(oc, *construct_2d_mesh(oc))
                 for oc in objs_cfg]
        objs = [s[0] for s in scene]
        states = tuple(s[1] for s in scene)
        frame = make_contact_frame_fn(objs, cfg)
        obstacles = Obstacles.from_configs((), 2)
        for _ in range(80):  # settle onto the slab
            states, _ = frame(states, obstacles)
        top = states[1]
        states = (states[0], top.replace(vel=top.vel.at[:, 0].add(1.0)))
        m = np.asarray(objs[1].mass)
        ts, vxs = [], []
        for i in range(100):
            states, _ = frame(states, obstacles)
            if i >= 20 and i % 5 == 0:
                v = np.asarray(states[1].vel)
                vxs.append(float(m @ v[:, 0] / m.sum()))
                ts.append(i * 5 * 5e-4)
        assert np.isfinite(np.asarray(states[1].pos)).all()
        return -np.polyfit(ts, vxs, 1)[0]

    d0 = run(0.0)
    d3 = run(0.3)
    assert d0 < 0.6  # isotropic dashpot alone barely couples the slide
    assert 1.5 < d3 < 3.5  # order mu*g = 2.94 (measured 2.1 on CPU)
    assert d3 > 4 * d0


def test_contact_mu_broadphase_routing():
    """contact_mu works on BOTH broad phases: auto keeps dense for small
    scenes (the explicit-pair-tensor Coulomb variant) and still flips to
    grid for many-body scenes."""
    from fem_tpu.contact import build_contact_plan
    from fem_tpu.models.mesh import construct_2d_mesh
    from fem_tpu.models.state import build_object
    from fem_tpu.utils.config import ObjectConfig, SimConfig

    oc = ObjectConfig(center=(0.4, 0.4), side_length=0.2, subdivisions=4)
    obj, _ = build_object(oc, *construct_2d_mesh(oc))
    base = dict(
        dim=2, delta_time=5e-4, sim_count=5, auto_diff=False,
        use_explicit_method=True, implicit_method=1, preconditioned=0,
        g_dir=(0.0, -1.0), blocks=(), contact="penalty", contact_mu=0.4,
    )
    plan = build_contact_plan([obj, obj], SimConfig(**base), 0.03)
    assert plan.mode == "dense"  # tiny scene: pair tensors fit easily
    plan_many = build_contact_plan(
        [obj] * 9, SimConfig(**base), 0.03
    )
    assert plan_many.mode == "grid"  # >8 bodies: trace-time O(B²) unroll


def test_dense_mu_matches_grid_mu():
    """The dense explicit-pair-tensor Coulomb variant and the grid's
    in-candidate Coulomb implement the SAME regularized cone: identical
    pair set (no cell overflow) ⇒ forces agree to f32 rounding.  Covers
    body-body pairs and masked self-contact."""
    from fem_tpu.contact import _pair_mu_forces

    pos_a, pos_b = _two_clouds(d=3, na=70, nb=55)
    radius, k, mu, slope = 0.06, 1e3, 0.5, 30.0
    rng = np.random.default_rng(7)
    vel_a = jnp.asarray(rng.standard_normal(pos_a.shape), jnp.float32)
    vel_b = jnp.asarray(rng.standard_normal(pos_b.shape), jnp.float32)
    f_a, f_b = _pair_mu_forces(
        pos_a, pos_b, vel_a, vel_b, radius, k,
        friction_c=1.5, mu=mu, mu_slope=slope,
    )
    pos = jnp.concatenate([pos_a, pos_b])
    vel = jnp.concatenate([vel_a, vel_b])
    body = jnp.concatenate([
        jnp.zeros(pos_a.shape[0], jnp.int32),
        jnp.ones(pos_b.shape[0], jnp.int32),
    ])
    assert grid_overflow_count(np.asarray(pos), radius, cap=16) == 0
    f = grid_contact_forces(
        pos, body, pos, radius, k, vel=vel, friction_c=1.5, cap=16,
        mu=mu, mu_slope=slope,
    )
    scale = float(jnp.abs(f_a).max())
    np.testing.assert_allclose(
        np.asarray(f[:pos_a.shape[0]]), np.asarray(f_a),
        atol=2e-5 * scale, rtol=0,
    )
    np.testing.assert_allclose(
        np.asarray(f[pos_a.shape[0]:]), np.asarray(f_b),
        atol=2e-5 * scale, rtol=0,
    )
    # Momentum: antisymmetric per pair on both paths.
    np.testing.assert_allclose(
        np.asarray(jnp.sum(f_a, 0) + jnp.sum(f_b, 0)), 0.0,
        atol=1e-4 * scale,
    )


def test_self_contact_mu_matches_grid():
    """Masked same-body Coulomb (dense explicit tensors) vs the grid's
    rest-distance-excluded self-contact on the bent-strip fold."""
    from fem_tpu.contact import self_contact_forces

    n = 80
    t = np.linspace(0.0, 1.0, n, dtype=np.float32)
    rest = np.stack([0.05 + 0.9 * t, 0.5 * np.ones_like(t)], 1)
    ang = 1.95 * np.pi * t
    bent = np.stack(
        [0.3 + 0.25 * np.sin(ang), 0.5 + 0.25 * (1 - np.cos(ang))], 1
    ).astype(np.float32)
    rng = np.random.default_rng(3)
    vel = jnp.asarray(rng.standard_normal(bent.shape), jnp.float32)
    radius, k, mu, slope = 0.05, 1e3, 0.4, 20.0
    excl = 2.5 * radius
    d_rest = np.linalg.norm(rest[:, None] - rest[None, :], axis=-1)
    mask = jnp.asarray((d_rest > excl).astype(np.float32))
    f_dense = self_contact_forces(
        jnp.asarray(bent), mask, radius, k, vel=vel,
        friction_c=0.0, mu=mu, mu_slope=slope,
    )
    assert grid_overflow_count(bent, radius, cap=16) == 0
    f_grid = grid_contact_forces(
        jnp.asarray(bent), jnp.zeros(n, jnp.int32), jnp.asarray(rest),
        radius, k, vel=vel, cap=16, self_contact=True, mu=mu,
        mu_slope=slope,
    )
    assert float(jnp.abs(f_dense).max()) > 0.0
    scale = float(jnp.abs(f_dense).max())
    np.testing.assert_allclose(
        np.asarray(f_grid), np.asarray(f_dense), atol=2e-5 * scale,
        rtol=0,
    )
