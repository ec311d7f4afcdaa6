# coding=utf-8
"""Shared test fixtures: tiny meshes and reference-config builders."""

import numpy as np

from fem_tpu.models.mesh import construct_2d_mesh
from fem_tpu.models.state import Obstacles, build_object
from fem_tpu.utils.config import BlockConfig, ObjectConfig, SimConfig


def make_2d_object(subdivisions=4, side_length=0.2, center=(0.5, 0.8), **mat):
    cfg = ObjectConfig(
        center=center, side_length=side_length, subdivisions=subdivisions, **mat
    )
    vertices, faces, elements = construct_2d_mesh(cfg)
    obj, state = build_object(cfg, vertices, faces, elements)
    return cfg, obj, state


def single_tet_object(**mat):
    """One unit tetrahedron."""
    cfg = ObjectConfig(center=(0.0, 0.0, 0.0), **mat)
    vertices = np.array(
        [[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32
    )
    faces = np.array([[0, 2, 1], [0, 1, 3], [0, 3, 2], [1, 2, 3]], np.int32)
    elements = np.array([[0, 1, 2, 3]], np.int32)
    obj, state = build_object(cfg, vertices, faces, elements)
    return cfg, obj, state


def two_tet_object(**mat):
    """Two tets sharing a face (5 particles)."""
    cfg = ObjectConfig(center=(0.0, 0.0, 0.0), **mat)
    vertices = np.array(
        [[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 1]], np.float32
    )
    faces = np.zeros((0, 3), np.int32)
    elements = np.array([[0, 1, 2, 3], [1, 2, 3, 4]], np.int32)
    obj, state = build_object(cfg, vertices, faces, elements)
    return cfg, obj, state


def default_sim_config(**overrides):
    """The shipped default.json semantics (2D square, two circle blocks)."""
    base = dict(
        dim=2,
        delta_time=5e-4,
        sim_count=10,
        auto_diff=True,
        use_explicit_method=True,
        implicit_method=0,
        preconditioned=1,
        g_dir=(0.0, -1.0),
        objects=(ObjectConfig(),),
        blocks=(
            BlockConfig(id=0, block_center=(0.8, 0.5), block_radius=0.21),
            BlockConfig(id=1, block_center=(0.2, 0.5), block_radius=0.21),
        ),
    )
    base.update(overrides)
    return SimConfig(**base)


def default_obstacles(dim=2):
    return Obstacles.from_configs(
        (
            BlockConfig(id=0, block_center=(0.8, 0.5), block_radius=0.21),
            BlockConfig(id=1, block_center=(0.2, 0.5), block_radius=0.21),
        ),
        dim,
    )


def make_3d_object(subdivisions=4, side_length=0.2, center=(0.4, 0.6, 0.4),
                   **mat):
    """Structured 3D tet-grid body (construct_3d_grid_mesh — 6·sub³ tets)."""
    from fem_tpu.models.mesh import construct_3d_grid_mesh

    cfg = ObjectConfig(
        center=center, side_length=side_length, subdivisions=subdivisions,
        **mat
    )
    vertices, faces, elements = construct_3d_grid_mesh(cfg)
    obj, state = build_object(cfg, vertices, faces, elements)
    return cfg, obj, state


def default_sim_config_3d(**overrides):
    """3D counterpart of default_sim_config (demo_3d.json semantics: no
    obstacle blocks, gravity -y)."""
    base = dict(
        dim=3,
        delta_time=5e-4,
        sim_count=10,
        auto_diff=False,
        use_explicit_method=False,
        implicit_method=1,
        preconditioned=1,
        g_dir=(0.0, -1.0, 0.0),
        objects=(ObjectConfig(center=(0.4, 0.6, 0.4)),),
        blocks=(),
    )
    base.update(overrides)
    return SimConfig(**base)


def attach_edge_matrix(obj):
    """Attach the dense edge matrix (built on demand since build_object
    only constructs it when operator_mode="mxu" is forced)."""
    import jax.numpy as jnp

    from fem_tpu.solvers.implicit import build_edge_matrix

    return obj.replace(
        edge_matrix=jnp.asarray(
            build_edge_matrix(np.asarray(obj.element_indices),
                              obj.particle_cnt)
        )
    )


def cube_tet_mesh(spacing=0.4):
    """Unit-cube surface tetrahedralized by the native Delaunay mesher:
    (nodes, surface faces, tets)."""
    from fem_tpu.models.mesh import delaunay_tetrahedralize

    v = np.array(
        [
            [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
            [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
        ],
        np.float64,
    )
    f = np.array(
        [
            [0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7],
            [0, 1, 5], [0, 5, 4], [2, 3, 7], [2, 7, 6],
            [0, 4, 7], [0, 7, 3], [1, 2, 6], [1, 6, 5],
        ],
        np.int64,
    )
    nodes, tets = delaunay_tetrahedralize(v, f, spacing)
    return nodes, f, tets


def dense_system_from_blocks(obj, K, dt, beta=0.0):
    """Dense (N·d, N·d) implicit matrix A = I − dt·(dt+β)·M⁻¹·G(K) assembled
    from per-element blocks K by the reference's scatter loop
    (solver/implicit.py:151-194) in float64 numpy — independent of the
    matrix-free operator it checks."""
    K = np.asarray(K, np.float64)
    idx = np.asarray(obj.element_indices)
    d, n = obj.dim, obj.particle_cnt
    a = np.zeros((n, n, d, d))
    for e in range(idx.shape[0]):
        v0 = idx[e, 0]
        for i in range(1, d + 1):
            vi = idx[e, i]
            a[vi, vi] += K[e]
            a[vi, v0] -= K[e]
            a[v0, vi] -= K[e]
            a[v0, v0] += K[e]
    mass = np.asarray(obj.mass, np.float64)
    a = -dt * (dt + beta) * a / mass[:, None, None, None]
    a[np.arange(n), np.arange(n)] += np.eye(d)
    return a.transpose(0, 2, 1, 3).reshape(n * d, n * d)


def energy_gradient_f64(obj, pos, material=None):
    """∂U/∂x of the total elastic energy by reverse-mode AD in float64 —
    an independent check of the analytic force columns."""
    import jax

    from fem_tpu.ops.element import total_energy

    material = obj.material if material is None else material
    with jax.enable_x64(True):
        import jax.numpy as jnp

        g = jax.grad(total_energy)(
            jnp.asarray(np.asarray(pos), jnp.float64),
            jnp.asarray(np.asarray(obj.element_indices)),
            jnp.asarray(np.asarray(obj.ref_inv), jnp.float64),
            jnp.asarray(np.asarray(obj.volume), jnp.float64),
            obj.mu, obj.s_lambda, material,
        )
        return np.asarray(g)
