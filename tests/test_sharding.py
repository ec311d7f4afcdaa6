# coding=utf-8
"""Element-sharded execution on a fake 8-device CPU mesh: results must match
the single-device path for every solver method (SURVEY §4 multi-chip tests)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fem_tpu.parallel.sharding import (
    make_element_mesh,
    make_sharded_frame_fn,
    make_sharded_substep_fn,
    pad_elements,
)
from fem_tpu.models.state import Obstacles
from fem_tpu.sim import make_frame_fn, make_substep_fn
from tests.utils import (
    default_obstacles,
    default_sim_config,
    default_sim_config_3d,
    make_2d_object,
    make_3d_object,
)


def test_eight_fake_devices_available():
    assert len(jax.devices()) == 8


def test_pad_elements_zero_contribution():
    cfg, obj, state = make_2d_object(subdivisions=3)  # 18 elements
    padded = pad_elements(obj, 8)
    assert padded.element_cnt == 24
    assert float(jnp.sum(padded.volume[18:])) == 0.0
    # Padded elements repeat element 0's topology.
    np.testing.assert_array_equal(
        np.asarray(padded.element_indices[18:]),
        np.tile(np.asarray(obj.element_indices[:1]), (6, 1)),
    )


@pytest.mark.parametrize(
    "overrides",
    [
        dict(auto_diff=False, use_explicit_method=True),
        dict(auto_diff=True, use_explicit_method=True),
        dict(auto_diff=False, use_explicit_method=False, implicit_method=1,
             preconditioned=1),
        dict(auto_diff=False, use_explicit_method=False, implicit_method=1,
             preconditioned=0),
        dict(auto_diff=False, use_explicit_method=False, implicit_method=0),
    ],
    ids=["explicit", "autodiff", "cg-precond", "cg-plain", "jacobi"],
)
def test_sharded_substep_matches_single_device(overrides):
    cfg_all = default_sim_config(sim_count=2, **overrides)
    _, obj, state = make_2d_object(subdivisions=4)
    obstacles = default_obstacles()
    mesh = make_element_mesh(8)

    single = make_substep_fn(obj, cfg_all)
    sharded = make_sharded_substep_fn(obj, cfg_all, mesh)

    s1, _ = single(state, obstacles)
    s2, _ = sharded(state, obstacles)
    np.testing.assert_allclose(
        np.asarray(s1.pos), np.asarray(s2.pos), rtol=1e-5, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(s1.vel), np.asarray(s2.vel), rtol=1e-4, atol=1e-6
    )


def test_2d_mesh_batch_by_elements():
    """Composed parallelism: 4 ensemble members × 2 element shards on the
    8-device CPU mesh must match the single-device batched path."""
    from fem_tpu.batch import broadcast_state, make_batched_frame_fn
    from fem_tpu.parallel.sharding import (
        make_2d_mesh,
        make_batched_sharded_frame_fn,
    )

    cfg_all = default_sim_config(
        auto_diff=False, use_explicit_method=False, implicit_method=1,
        preconditioned=1, sim_count=2,
    )
    _, obj, state = make_2d_object(subdivisions=4)
    obstacles = default_obstacles()
    states = broadcast_state(state, 4)
    # Perturb members so they differ.
    import numpy as _np

    rng = _np.random.default_rng(0)
    states = states.replace(
        pos=states.pos
        + jnp.asarray(
            rng.normal(scale=1e-4, size=states.pos.shape).astype(_np.float32)
        )
    )

    mesh2d = make_2d_mesh(4, 2)
    sharded = make_batched_sharded_frame_fn(obj, cfg_all, mesh2d)
    plain = make_batched_frame_fn(obj, cfg_all)

    s1, aux1 = sharded(states, obstacles)
    s2, aux2 = plain(states, obstacles)
    np.testing.assert_allclose(
        np.asarray(s1.pos), np.asarray(s2.pos), rtol=1e-5, atol=1e-6
    )
    assert aux1.solver_iterations.shape == (4, 2)


@pytest.mark.parametrize(
    "overrides",
    [
        dict(auto_diff=False, use_explicit_method=True),
        dict(auto_diff=True, use_explicit_method=True),
        dict(auto_diff=False, use_explicit_method=False, implicit_method=1,
             preconditioned=1),
        dict(auto_diff=False, use_explicit_method=False, implicit_method=1,
             preconditioned=0),
        dict(auto_diff=False, use_explicit_method=False, implicit_method=0),
    ],
    ids=["explicit", "autodiff", "cg-precond", "cg-plain", "jacobi"],
)
def test_sharded_3d_tet_substep_matches_single_device(overrides):
    """3D tet mesh under shard_map (SURVEY §5 'meshes that exceed one chip'
    are exactly the 3D ones): every method variant must match the
    single-device path.  Element arrays shard across devices; every
    assembly and operator apply ends in one psum."""
    cfg_all = default_sim_config_3d(sim_count=2, **overrides)
    _, obj, state = make_3d_object(subdivisions=3)
    obstacles = Obstacles.from_configs((), 3)
    mesh = make_element_mesh(8)

    # Non-rest start so forces / CG iterations are non-trivial.
    rng = np.random.default_rng(3)
    state = state.replace(
        vel=jnp.asarray(
            rng.normal(scale=0.2, size=state.pos.shape).astype(np.float32)
        )
    )

    single = make_substep_fn(obj, cfg_all)
    sharded = make_sharded_substep_fn(obj, cfg_all, mesh)

    s1, aux1 = single(state, obstacles)
    s2, aux2 = sharded(state, obstacles)
    np.testing.assert_allclose(
        np.asarray(s1.pos), np.asarray(s2.pos), rtol=1e-5, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(s1.vel), np.asarray(s2.vel), rtol=1e-4, atol=1e-5
    )


def test_sharded_body_pads_and_shards_elements():
    """The sharded copy pads elements to a multiple of the device count with
    zero-volume copies of element 0, shards element arrays over the mesh
    axis and replicates particle arrays."""
    from jax.sharding import PartitionSpec as P

    from fem_tpu.parallel.sharding import AXIS, _prep_body

    cfg_all = default_sim_config_3d(implicit_method=1, preconditioned=1)
    _, obj, state = make_3d_object(subdivisions=3)
    padded, spec, local_cnt = _prep_body(obj, cfg_all, 8)
    assert padded.element_cnt % 8 == 0 and padded.element_cnt >= obj.element_cnt
    assert local_cnt == padded.element_cnt // 8
    extra = padded.element_cnt - obj.element_cnt
    if extra:
        assert float(jnp.abs(padded.volume[obj.element_cnt:]).max()) == 0.0
    assert spec.element_indices == P(AXIS) and spec.ref_inv == P(AXIS)
    assert spec.mass == P() and spec.rest_pos == P()
    assert padded.edge_matrix is None


def test_sharded_3d_tet_frame_matches_single_device_cg():
    """Whole-frame (lax.scan over substeps) sharded parity on a 3D tet mesh
    through multiple substeps of preconditioned CG."""
    cfg_all = default_sim_config_3d(
        implicit_method=1, preconditioned=1, sim_count=3
    )
    _, obj, state = make_3d_object(subdivisions=3)
    obstacles = Obstacles.from_configs((), 3)
    mesh = make_element_mesh(8)

    rng = np.random.default_rng(7)
    state = state.replace(
        vel=jnp.asarray(
            rng.normal(scale=0.2, size=state.pos.shape).astype(np.float32)
        )
    )
    s1, _ = make_frame_fn(obj, cfg_all)(state, obstacles)
    s2, _ = make_sharded_frame_fn(obj, cfg_all, mesh)(state, obstacles)
    np.testing.assert_allclose(
        np.asarray(s1.pos), np.asarray(s2.pos), rtol=1e-5, atol=1e-6
    )


def test_sharded_frame_matches_single_device_explicit():
    cfg_all = default_sim_config(
        auto_diff=False, use_explicit_method=True, sim_count=5
    )
    _, obj, state = make_2d_object(subdivisions=4)
    obstacles = default_obstacles()
    mesh = make_element_mesh(8)

    s1, _ = make_frame_fn(obj, cfg_all)(state, obstacles)
    s2, _ = make_sharded_frame_fn(obj, cfg_all, mesh)(state, obstacles)
    np.testing.assert_allclose(
        np.asarray(s1.pos), np.asarray(s2.pos), rtol=1e-5, atol=1e-6
    )


def test_sharded_3d_matches_oracle():
    """Sharded implicit CG (parity default) on a 3D tet mesh against the
    float64 oracle (tests/oracle.py) from the same state."""
    from tests.oracle import Oracle

    cfg_all = default_sim_config_3d(
        sim_count=1, implicit_method=1, preconditioned=1
    )
    ocfg, obj, state = make_3d_object(subdivisions=3)
    obstacles = Obstacles.from_configs((), 3)
    mesh = make_element_mesh(8)
    rng = np.random.default_rng(5)
    state = state.replace(
        vel=jnp.asarray(
            rng.normal(scale=0.2, size=state.pos.shape).astype(np.float32)
        )
    )
    oracle = Oracle(
        np.asarray(state.pos, np.float64), np.asarray(obj.element_indices),
        ocfg.rho, ocfg.mu, ocfg.s_lambda, ocfg.damping,
    )
    oracle.vel = np.asarray(state.vel, np.float64)
    sharded = make_sharded_substep_fn(obj, cfg_all, mesh)
    s = state
    for _ in range(5):
        s, _ = sharded(s, obstacles)
        oracle.step_implicit_cg(
            cfg_all.delta_time, cfg_all.g_dir, [], preconditioned=1
        )
    np.testing.assert_allclose(np.asarray(s.pos), oracle.pos, atol=5e-4)
    np.testing.assert_allclose(np.asarray(s.vel), oracle.vel, atol=5e-3)


@pytest.mark.parametrize(
    "overrides",
    [
        dict(cg_precond="block_jacobi"),
        dict(cg_precond="none"),
    ],
    ids=["block-jacobi", "plain-by-name"],
)
def test_sharded_cg_precond_matches_single_device(overrides):
    """Round-4 cg_precond extension under shard_map: the block-Jacobi
    diagonal assembles per-shard (segment_assemble + psum) and the PCG
    iterations run replicated — must match the single-device result."""
    cfg_all = default_sim_config_3d(
        sim_count=2, implicit_method=1, preconditioned=1, **overrides
    )
    _, obj, state = make_3d_object(subdivisions=3)
    obstacles = Obstacles.from_configs((), 3)
    mesh = make_element_mesh(8)
    rng = np.random.default_rng(7)
    state = state.replace(
        vel=jnp.asarray(
            rng.normal(scale=0.2, size=state.pos.shape).astype(np.float32)
        )
    )
    single = make_substep_fn(obj, cfg_all)
    sharded = make_sharded_substep_fn(obj, cfg_all, mesh)
    s1, aux1 = single(state, obstacles)
    s2, aux2 = sharded(state, obstacles)
    np.testing.assert_allclose(
        np.asarray(s1.vel), np.asarray(s2.vel), rtol=1e-4, atol=1e-5
    )
    assert int(aux1.solver_iterations) == int(aux2.solver_iterations)


def test_sharded_material_matches_single_device():
    """Round-4 material-generic decoupled Hessian under shard_map
    (corotated: polar decomposition inside the per-shard element chain)."""
    cfg_all = default_sim_config_3d(
        sim_count=2, implicit_method=1, preconditioned=0,
    )
    _, obj, state = make_3d_object(subdivisions=3)
    obj = obj.replace(material="corotated")
    obstacles = Obstacles.from_configs((), 3)
    mesh = make_element_mesh(8)
    rng = np.random.default_rng(9)
    state = state.replace(
        vel=jnp.asarray(
            rng.normal(scale=0.2, size=state.pos.shape).astype(np.float32)
        )
    )
    single = make_substep_fn(obj, cfg_all)
    sharded = make_sharded_substep_fn(obj, cfg_all, mesh)
    s1, _ = single(state, obstacles)
    s2, _ = sharded(state, obstacles)
    np.testing.assert_allclose(
        np.asarray(s1.vel), np.asarray(s2.vel), rtol=1e-4, atol=1e-5
    )


def test_sharded_newton_matches_single_device():
    """Round-4 integrator="newton" under shard_map: force assemblies and
    HVPs psum per-shard, the Newton/CG/line-search iterations run
    replicated — must match the single-device result."""
    cfg_all = default_sim_config_3d(
        sim_count=2, implicit_method=1, preconditioned=0,
        integrator="newton",
    )
    _, obj, state = make_3d_object(subdivisions=3)
    obstacles = Obstacles.from_configs((), 3)
    mesh = make_element_mesh(8)
    rng = np.random.default_rng(11)
    state = state.replace(
        vel=jnp.asarray(
            rng.normal(scale=0.3, size=state.pos.shape).astype(np.float32)
        )
    )
    single = make_substep_fn(obj, cfg_all)
    sharded = make_sharded_substep_fn(obj, cfg_all, mesh)
    s1, aux1 = single(state, obstacles)
    s2, aux2 = sharded(state, obstacles)
    np.testing.assert_allclose(
        np.asarray(s1.vel), np.asarray(s2.vel), rtol=1e-4, atol=1e-5
    )
    # Real Newton work happened (not a trivially-converged zero residual).
    assert int(aux1.solver_iterations) > 0


def test_sharded_newton_decoupled_matches_single_device():
    """newton_hessian="decoupled" under shard_map: each Newton step's prep
    and operator run per-shard (one psum per assembly/apply)."""
    cfg_all = default_sim_config_3d(
        sim_count=2, implicit_method=1, preconditioned=0,
        integrator="newton", newton_hessian="decoupled",
    )
    _, obj, state = make_3d_object(subdivisions=3)
    obstacles = Obstacles.from_configs((), 3)
    mesh = make_element_mesh(8)
    rng = np.random.default_rng(13)
    state = state.replace(
        vel=jnp.asarray(
            rng.normal(scale=0.3, size=state.pos.shape).astype(np.float32)
        )
    )
    single = make_substep_fn(obj, cfg_all)
    sharded = make_sharded_substep_fn(obj, cfg_all, mesh)
    s1, aux1 = single(state, obstacles)
    s2, aux2 = sharded(state, obstacles)
    np.testing.assert_allclose(
        np.asarray(s1.vel), np.asarray(s2.vel), rtol=1e-4, atol=1e-5
    )
    assert int(aux1.solver_iterations) > 0


@pytest.mark.parametrize(
    "overrides",
    [
        dict(use_explicit_method=True),
        dict(use_explicit_method=False, implicit_method=1, preconditioned=0),
    ],
    ids=["explicit", "implicit-cg"],
)
def test_sharded_contact_matches_single_device(overrides):
    """Round-5 gate lift (VERDICT r4 #2a): body-body penalty contact under
    shard_map — pair forces replicated, element work sharded per body —
    must match the single-device contact frame."""
    from fem_tpu.contact import make_contact_frame_fn
    from fem_tpu.models.mesh import construct_2d_mesh
    from fem_tpu.models.state import build_object
    from fem_tpu.parallel.sharding import make_sharded_contact_frame_fn
    from fem_tpu.utils.config import ObjectConfig, SimConfig

    objs, states = [], []
    for i, (cx, cy, rho, e_mod) in enumerate(
        ((0.5, 0.35, 800.0, 8e4), (0.5, 0.62, 500.0, 4e4))
    ):
        ocfg = ObjectConfig(
            id=i, center=(cx, cy), side_length=0.18, subdivisions=5,
            rho=rho, E=e_mod, nu=0.25, damping=10.0,
        )
        v, f, e = construct_2d_mesh(ocfg)
        obj, state = build_object(ocfg, v, f, e)
        objs.append(obj)
        states.append(state)
    cfg = SimConfig(
        dim=2, delta_time=5e-4, sim_count=5, auto_diff=False,
        g_dir=(0.0, -1.0), contact="penalty", **overrides
    )
    mesh = make_element_mesh(8)
    single = make_contact_frame_fn(objs, cfg)
    sharded = make_sharded_contact_frame_fn(objs, cfg, mesh)
    ss, sh = tuple(states), tuple(states)
    obstacles = Obstacles.from_configs((), 2)
    for _ in range(4):
        ss, _ = single(ss, obstacles)
        sh, _ = sharded(sh, obstacles)
    for a, b in zip(ss, sh):
        np.testing.assert_allclose(
            np.asarray(a.pos), np.asarray(b.pos), rtol=1e-4, atol=1e-5
        )


def test_simulation_api_sharded_contact():
    """Simulation(sharded=True, contact='penalty') routes through the
    sharded contact frame (the round-4 loud gate is lifted)."""
    from fem_tpu.api import Simulation

    spec = {
        "dim": 2, "delta_time": 5e-4, "sim_count": 5,
        "use_explicit_method": True, "g_dir": [0.0, -1.0],
        "contact": "penalty",
        "objects": [
            {"id": 0, "center": [0.5, 0.3], "side_length": 0.15,
             "subdivisions": 4},
            {"id": 1, "center": [0.5, 0.55], "side_length": 0.15,
             "subdivisions": 4},
        ],
        "blocks": [],
    }
    sim = Simulation.from_dict(spec, sharded=True)
    sim_ref = Simulation.from_dict(spec)
    for _ in range(3):
        sim.step_frame()
        sim_ref.step_frame()
    np.testing.assert_allclose(
        sim.positions(0), sim_ref.positions(0), rtol=1e-4, atol=1e-5
    )
    np.testing.assert_allclose(
        sim.positions(1), sim_ref.positions(1), rtol=1e-4, atol=1e-5
    )
