# coding=utf-8
"""SDF obstacle extensions (halfspace / solid box / sphere / mesh SDF).

The reference's only obstacles are circles (circle_blocks.py) and the sticky
unit-box walls (kinematic.py:25-30); fem_tpu/obstacles.py generalizes the
circle slide semantics to signed distance fields."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from fem_tpu.models.state import Obstacles
from fem_tpu.obstacles import (
    apply_extensions_explicit,
    apply_extensions_implicit,
    build_mesh_sdf,
    has_extensions,
    sample_sdf_grid,
)
from fem_tpu.sim import make_substep_fn
from fem_tpu.utils.config import (
    BlockConfig,
    ObstacleConfig,
    SimConfig,
    parse_config,
)
from tests.utils import make_2d_object


def _halfspace_obstacles(point, normal, dim=2):
    return Obstacles.from_configs(
        (), dim,
        (ObstacleConfig(type="halfspace", point=point, normal=normal),),
    )


def test_config_parse_obstacles():
    cfg = parse_config(
        {
            "obstacles": [
                {"type": "halfspace", "point": [0, 0.2], "normal": [0, 1]},
                {"type": "box", "lo": [0.4, 0.0], "hi": [0.6, 0.3]},
                {"type": "sphere", "center": [0.5, 0.5], "radius": 0.1},
            ]
        }
    )
    assert len(cfg.obstacles) == 3
    assert cfg.obstacles[0].type == "halfspace"
    assert parse_config({}).obstacles == ()


def test_sphere_equals_reference_circle():
    """A `sphere` obstacle folds into the circle arrays — identical
    semantics to a reference block."""
    via_block = Obstacles.from_configs(
        (BlockConfig(block_center=(0.5, 0.4), block_radius=0.2),), 2
    )
    via_sphere = Obstacles.from_configs(
        (), 2,
        (ObstacleConfig(type="sphere", center=(0.5, 0.4), radius=0.2),),
    )
    np.testing.assert_array_equal(
        np.asarray(via_block.centers), np.asarray(via_sphere.centers)
    )
    np.testing.assert_array_equal(
        np.asarray(via_block.radii), np.asarray(via_sphere.radii)
    )
    assert not has_extensions(via_sphere)


def test_halfspace_slide_semantics():
    obs = _halfspace_obstacles((0.0, 0.5), (0.0, 1.0))
    pos = jnp.array(
        [[0.3, 0.45], [0.3, 0.45], [0.3, 0.6]], jnp.float32
    )  # two inside the solid (y<0.5), one outside
    v = jnp.array(
        [[0.2, -1.0], [0.2, 1.0], [0.2, -1.0]], jnp.float32
    )  # into / out of / outside
    v2 = np.asarray(apply_extensions_explicit(pos, v, obs))
    # Penetrating + inward: normal (y) component removed, tangential kept.
    np.testing.assert_allclose(v2[0], [0.2, 0.0], atol=1e-7)
    # Penetrating but moving out: untouched.
    np.testing.assert_allclose(v2[1], [0.2, 1.0], atol=1e-7)
    # Outside: untouched.
    np.testing.assert_allclose(v2[2], [0.2, -1.0], atol=1e-7)


def test_tilted_halfspace_slide():
    """Normals need not be axis-aligned (the reference box is)."""
    n = np.array([1.0, 2.0]) / np.sqrt(5.0)
    obs = _halfspace_obstacles((0.5, 0.5), tuple(n))
    pos = jnp.array([[0.45, 0.45]], jnp.float32)  # solid side
    v = jnp.array([[-1.0, -1.0]], jnp.float32)  # into the plane
    v2 = np.asarray(apply_extensions_explicit(pos, v, obs))[0]
    assert abs(float(np.dot(v2, n))) < 1e-6  # normal component gone
    tang = np.array([-n[1], n[0]])
    np.testing.assert_allclose(
        float(np.dot(v2, tang)), float(np.dot([-1.0, -1.0], tang)),
        atol=1e-6,
    )


def test_box_normals_and_slide():
    obs = Obstacles.from_configs(
        (), 2,
        (ObstacleConfig(type="box", lo=(0.4, 0.0), hi=(0.6, 0.3)),),
    )
    # Just inside the top face moving down -> vertical component removed.
    pos = jnp.array([[0.5, 0.29], [0.41, 0.15], [0.5, 0.5]], jnp.float32)
    v = jnp.array([[0.3, -1.0], [1.0, -0.2], [0.0, -1.0]], jnp.float32)
    v2 = np.asarray(apply_extensions_explicit(pos, v, obs))
    np.testing.assert_allclose(v2[0], [0.3, 0.0], atol=1e-7)  # top face
    # Near the left face moving right (deeper): x removed, y kept.
    np.testing.assert_allclose(v2[1], [0.0, -0.2], atol=1e-7)
    np.testing.assert_allclose(v2[2], [0.0, -1.0], atol=1e-7)  # outside


def test_implicit_channels_both_projected():
    obs = _halfspace_obstacles((0.0, 0.5), (0.0, 1.0))
    pos = jnp.array([[0.3, 0.45]], jnp.float32)
    vel = jnp.array([[0.1, -0.4]], jnp.float32)
    vel_g = jnp.array([[0.0, -0.6]], jnp.float32)
    v = vel + vel_g
    v2, vel2, velg2 = apply_extensions_implicit(pos, v, vel, vel_g, obs)
    np.testing.assert_allclose(np.asarray(v2)[0], [0.1, 0.0], atol=1e-7)
    np.testing.assert_allclose(np.asarray(vel2)[0], [0.1, 0.0], atol=1e-7)
    np.testing.assert_allclose(np.asarray(velg2)[0], [0.0, 0.0], atol=1e-7)


@pytest.mark.parametrize("method", ["explicit", "implicit"])
def test_body_rests_on_tilted_plane(method):
    """Drop the 2D body onto a gently tilted plane: it must not pass
    through (velocity-level collisions allow O(dt·v) penetration, like the
    reference's circles)."""
    n = np.array([0.2, 1.0])
    n = n / np.linalg.norm(n)
    cfg = SimConfig(
        dim=2, delta_time=5e-4, sim_count=10,
        auto_diff=False, use_explicit_method=(method == "explicit"),
        implicit_method=1, preconditioned=0, g_dir=(0.0, -1.0),
        obstacles=(
            ObstacleConfig(
                type="halfspace", point=(0.5, 0.3), normal=tuple(n)
            ),
        ),
    )
    _, obj, state = make_2d_object(center=(0.5, 0.55))
    obstacles = Obstacles.from_configs((), 2, cfg.obstacles)
    fn = make_substep_fn(obj, cfg)
    for _ in range(1600):
        state, _ = fn(state, obstacles)
    p = np.asarray(state.pos)
    assert np.all(np.isfinite(p))
    sd = (p - np.array([0.5, 0.3])[None, :]) @ n
    assert float(sd.min()) > -0.02  # resting on, not through
    # And it actually fell onto the plane (some contact happened).
    assert float(sd.min()) < 0.05


def test_frictionless_spheres_fold_into_circles():
    """A frictionless sphere obstacle joins the reference circle arrays;
    half-spaces stay on the SDF extension path."""
    from fem_tpu.obstacles import has_extensions

    obs = Obstacles.from_configs(
        (), 3,
        (ObstacleConfig(type="sphere", center=(0.5, 0.1, 0.5), radius=0.2),),
    )
    assert not has_extensions(obs)
    np.testing.assert_allclose(np.asarray(obs.radii), [0.2])
    obs = Obstacles.from_configs(
        (), 3,
        (ObstacleConfig(type="halfspace", point=(0, 0.1, 0),
                        normal=(0, 1, 0)),),
    )
    assert has_extensions(obs)


def _write_cube_obj(path, lo=-0.5, hi=0.5):
    v = np.array(
        [
            [lo, lo, lo], [hi, lo, lo], [hi, hi, lo], [lo, hi, lo],
            [lo, lo, hi], [hi, lo, hi], [hi, hi, hi], [lo, hi, hi],
        ]
    )
    f = [
        [0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7],
        [0, 1, 5], [0, 5, 4], [2, 3, 7], [2, 7, 6],
        [1, 2, 6], [1, 6, 5], [0, 4, 7], [0, 7, 3],
    ]
    with open(path, "w") as fh:
        for p in v:
            fh.write(f"v {p[0]} {p[1]} {p[2]}\n")
        for a, b, c in f:
            fh.write(f"f {a + 1} {b + 1} {c + 1}\n")


def test_mesh_sdf_build_and_sample(tmp_path):
    path = str(tmp_path / "cube.obj")
    _write_cube_obj(path)
    grid, origin, spacing = build_mesh_sdf(
        path, scale=1.0, offset=(0.5, 0.5, 0.5), resolution=24
    )
    # Unit cube centered at (0.5, 0.5, 0.5).
    pts = jnp.array(
        [
            [0.5, 0.5, 0.5],   # center: inside, depth 0.5
            [0.5, 0.5, 1.2],   # outside above: dist 0.2
            [0.5, 0.5, 0.95],  # inside near top: depth 0.05
        ],
        jnp.float32,
    )
    phi = np.asarray(
        sample_sdf_grid(
            jnp.asarray(grid), jnp.asarray(origin), jnp.float32(spacing), pts
        )
    )
    assert phi[0] < -0.3
    assert abs(phi[1] - 0.2) < 2.5 * spacing
    assert phi[2] < 0.0
    # Collision: a point just inside the top face moving down slides.
    obs = Obstacles.from_configs(
        (), 3,
        (
            ObstacleConfig(
                type="mesh", obj=path, offset=(0.5, 0.5, 0.5),
                resolution=24,
            ),
        ),
    )
    assert has_extensions(obs)
    pos = jnp.array([[0.5, 0.5, 0.97]], jnp.float32)
    v = jnp.array([[0.3, 0.1, -1.0]], jnp.float32)
    v2 = np.asarray(apply_extensions_explicit(pos, v, obs))[0]
    assert abs(v2[2]) < 0.15  # normal (z) component mostly removed
    np.testing.assert_allclose(v2[:2], [0.3, 0.1], atol=0.05)


def test_mesh_obstacle_in_sim(tmp_path):
    """A falling 2-tet body lands on a mesh-SDF cube and stays above it."""
    path = str(tmp_path / "cube.obj")
    _write_cube_obj(path)
    cfg = SimConfig(
        dim=3, delta_time=5e-4, sim_count=10, auto_diff=False,
        use_explicit_method=True, implicit_method=1, preconditioned=0,
        g_dir=(0.0, 0.0, -1.0),
        obstacles=(
            ObstacleConfig(
                type="mesh", obj=path, scale=0.6,
                offset=(0.5, 0.5, 0.2), resolution=24,
            ),
        ),
    )
    # A small two-tet body built at rest, hovering above the cube top
    # (cube: scale 0.6 centered at (0.5, 0.5, 0.2) → top face z = 0.5).
    from fem_tpu.models.state import build_object
    from fem_tpu.utils.config import ObjectConfig

    ocfg = ObjectConfig(center=(0.44, 0.44, 0.56))
    vertices = 0.12 * np.array(
        [[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 1]], np.float32
    )
    elements = np.array([[0, 1, 2, 3], [1, 2, 3, 4]], np.int32)
    obj2, state2 = build_object(
        ocfg, vertices, np.zeros((0, 3), np.int32), elements
    )
    obstacles = Obstacles.from_configs((), 3, cfg.obstacles)
    fn = make_substep_fn(obj2, cfg)
    for _ in range(800):
        state2, _ = fn(state2, obstacles)
    p = np.asarray(state2.pos)
    assert np.all(np.isfinite(p))
    # Landed on (not through) the cube: every particle above top − pen.
    assert float(p[:, 2].min()) > 0.44
    assert float(p[:, 2].min()) < 0.56  # actually descended onto it


def test_kinematic_step_applies_extensions():
    """The explicit advection applies SDF extensions after the reference
    circles: a particle inside the half-space moving into it loses its
    normal velocity and keeps its tangential one."""
    from fem_tpu.models.state import SimState
    from fem_tpu.solvers.advect import kinematic_step

    pos = jnp.asarray([[0.3, 0.45]])
    zeros = jnp.zeros_like(pos)
    state = SimState(pos=pos, vel=jnp.asarray([[0.2, -1.0]]), vel_g=zeros,
                     force=zeros, jacobi_past_x=zeros)
    obs = _halfspace_obstacles((0.0, 0.5), (0.0, 1.0))
    out = kinematic_step(
        state, zeros, jnp.ones((1,)), obs, 1e-4, 0.0, (0.0, 0.0),
    )
    v = np.asarray(out.vel)
    assert abs(v[0, 1]) < 1e-6
    np.testing.assert_allclose(v[0, 0], 0.2, rtol=1e-6)
