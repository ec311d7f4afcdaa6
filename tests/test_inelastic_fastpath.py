# coding=utf-8
"""Inelastic materials on the fast execution paths (round-5, VERDICT r4 #1).

Plasticity/viscoelasticity are expressed as material layers
(ops/inelastic.material_layers) consumed by EVERY execution path — the
graph and mxu operators, every CG variant, Newton (decoupled + exact), the
explicit gradient, the differentiable substeps and the sharded path.  These
tests pin cross-path consistency; the physics itself is pinned in
tests/test_inelastic.py."""

import jax.numpy as jnp
import numpy as np
import pytest

from fem_tpu.models.state import Obstacles
from fem_tpu.sim import make_substep_fn
from fem_tpu.utils.config import SimConfig
from tests.utils import (
    attach_edge_matrix,
    default_obstacles,
    default_sim_config,
    make_2d_object,
    make_3d_object,
)


def _cfg(**overrides):
    base = dict(
        dim=2, delta_time=1e-4, sim_count=5, auto_diff=False,
        use_explicit_method=False, implicit_method=1, preconditioned=0,
        g_dir=(0.0, -1.0), blocks=(),
    )
    base.update(overrides)
    return SimConfig(**base)


def _kicked(state, scale=0.3, seed=3):
    rng = np.random.default_rng(seed)
    return state.replace(
        vel=jnp.asarray(
            rng.normal(scale=scale, size=state.pos.shape).astype(np.float32)
        )
    )


MATS = [
    dict(plastic_yield=0.02),
    dict(viscous_mu=1e4, viscous_tau=0.01),
    dict(plastic_yield=0.02, viscous_mu=1e4, viscous_tau=0.01),
]
MAT_IDS = ["plastic", "viscous", "both"]


def test_layer_ref_inv_local_composes_rest_inverse():
    """A layer's effective rest-edge inverse is R⁻¹·F_i⁻¹ per element (the
    pure elastic layer, F_i⁻¹ = None, is R⁻¹ itself)."""
    from fem_tpu.ops.inelastic import layer_ref_inv_local

    _, obj, state = make_2d_object(subdivisions=4, plastic_yield=0.02)
    rng = np.random.default_rng(0)
    fi = np.eye(2, dtype=np.float32) + 0.05 * rng.standard_normal(
        (obj.element_cnt, 2, 2)
    ).astype(np.float32)
    got = np.asarray(layer_ref_inv_local(obj.ref_inv, jnp.asarray(fi)))
    want = np.einsum("eij,ejk->eik", np.asarray(obj.ref_inv, np.float64), fi)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert layer_ref_inv_local(obj.ref_inv, None) is obj.ref_inv


@pytest.mark.parametrize("mat", MATS, ids=MAT_IDS)
@pytest.mark.parametrize(
    "fast",
    [
        dict(operator_mode="mxu"),
        dict(cg_precond="block_jacobi"),
        dict(preconditioned=1),
    ],
    ids=["mxu", "block-jacobi", "normal-equations"],
)
def test_implicit_fast_paths_match_graph(mat, fast):
    """Semi-implicit CG with inelastic layers: the dense edge-matrix
    operator, block-Jacobi PCG and the normal-equations CG solve the same
    layered system as plain CG on the graph operator (float reorder and
    solver tolerance only)."""
    cfg_graph = _cfg(operator_mode="graph")
    cfg_fast = _cfg(**fast)
    _, obj, state0 = make_2d_object(subdivisions=4, **mat)
    state0 = _kicked(state0)
    obstacles = default_obstacles()
    fn_g = make_substep_fn(obj, cfg_graph)
    fn_f = make_substep_fn(attach_edge_matrix(obj), cfg_fast)
    sg, sf = state0, state0
    for _ in range(20):
        sg, _ = fn_g(sg, obstacles)
        sf, _ = fn_f(sf, obstacles)
    np.testing.assert_allclose(
        np.asarray(sg.pos), np.asarray(sf.pos), rtol=1e-4, atol=2e-5
    )
    if sg.plastic_inv is not None:
        np.testing.assert_allclose(
            np.asarray(sg.plastic_inv), np.asarray(sf.plastic_inv),
            rtol=1e-4, atol=2e-5,
        )


@pytest.mark.parametrize("mat", MATS, ids=MAT_IDS)
def test_explicit_layered_gradient_backends_agree(mat):
    """The layered analytic gradient agrees with the direct inelastic
    gradient (graph chain) and with reverse-mode AD of the total inelastic
    energy at frozen internal variables."""
    import jax

    from fem_tpu.ops.inelastic import (
        inelastic_element_energies,
        inelastic_energy_gradient,
        material_layers,
    )
    from fem_tpu.solvers.explicit import analytic_energy_gradient

    _, obj, state = make_2d_object(subdivisions=4, **mat)
    state = _kicked(state, scale=0.0)
    # Deform so the return map/branch strain are non-trivial.
    pos = np.asarray(state.pos)
    c = pos.mean(0, keepdims=True)
    pos = c + (pos - c) @ np.array([[1.2, 0.05], [0.0, 0.9]], np.float32)
    state = state.replace(pos=jnp.asarray(pos))
    from fem_tpu.ops.inelastic import advance_internal

    state = advance_internal(obj, state, 1e-4)  # flow internal vars
    layers = material_layers(obj, state)
    ref = np.asarray(inelastic_energy_gradient(obj, state, state.pos))
    autodiff = np.asarray(jax.grad(
        lambda p: jnp.sum(inelastic_element_energies(obj, state, p))
    )(state.pos))
    got = np.asarray(analytic_energy_gradient(obj, state.pos, None, layers))
    scale = np.abs(ref).max()
    for name, other in (("direct", ref), ("autodiff", autodiff)):
        np.testing.assert_allclose(
            got, other, rtol=1e-4, atol=2e-5 * max(scale, 1.0),
            err_msg=name,
        )


@pytest.mark.parametrize("mat", MATS, ids=MAT_IDS)
def test_explicit_substep_backends_agree(mat):
    """The explicit layered substep matches the differentiable substep
    (fem_tpu/diff.py, an independent implementation of the same step)."""
    import jax

    from fem_tpu.diff import make_diff_substep_fn, params_from_object

    cfg = _cfg(use_explicit_method=True)
    _, obj, state0 = make_2d_object(subdivisions=4, **mat)
    state0 = _kicked(state0)
    obstacles = default_obstacles()
    diff_step = jax.jit(make_diff_substep_fn(obj, cfg))
    params = params_from_object(obj)
    fx = make_substep_fn(obj, cfg)

    def fp(s, obs):
        return diff_step(params, s, obs), None

    sx, sp = state0, state0
    for _ in range(20):
        sx, _ = fx(sx, obstacles)
        sp, _ = fp(sp, obstacles)
    np.testing.assert_allclose(
        np.asarray(sx.pos), np.asarray(sp.pos), rtol=1e-4, atol=2e-5
    )


@pytest.mark.parametrize("hessian_mode", ["decoupled", "exact"])
def test_newton_plastic_permanent_set(hessian_mode):
    """integrator='newton' with plasticity (gate lifted in round 5): squash
    far beyond yield, release — permanent set must remain, mirroring the
    semi-implicit behavior pinned in test_inelastic.py."""
    from fem_tpu.ops.inelastic import advance_internal

    mat = dict(plastic_yield=0.05, damping=80.0, E=4e4)
    cfg = _cfg(
        integrator="newton", newton_hessian=hessian_mode, delta_time=1e-4,
        g_dir=(0.0, 0.0),
    )
    _, obj, state = make_2d_object(**mat)
    obstacles = Obstacles.from_configs((), 2)
    fn = make_substep_fn(obj, cfg)
    rest = np.asarray(state.pos)
    squash = rest.copy()
    squash[:, 1] = squash[:, 1].min() + 0.6 * (
        squash[:, 1] - squash[:, 1].min()
    )
    state = state.replace(pos=jnp.asarray(squash.astype(np.float32)))
    state = advance_internal(obj, state, cfg.delta_time)
    assert np.abs(np.asarray(state.plastic_inv) - np.eye(2)).max() > 0.1
    for _ in range(400):
        state, _ = fn(state, obstacles)
    p = np.asarray(state.pos)
    assert np.all(np.isfinite(p))
    rest_h = rest[:, 1].max() - rest[:, 1].min()
    h = p[:, 1].max() - p[:, 1].min()
    assert h < 0.92 * rest_h  # permanent set survived the Newton solve


def test_newton_matches_semi_implicit_small_dt():
    """At small dt the Newton solve converges to the same linearized root
    the semi-implicit single solve produces — trajectories track closely
    with plastic flow active."""
    mat = dict(plastic_yield=0.02)
    cfg_semi = _cfg(delta_time=5e-5)
    cfg_newton = _cfg(
        delta_time=5e-5, integrator="newton", newton_hessian="decoupled"
    )
    _, obj, state0 = make_2d_object(subdivisions=4, **mat)
    state0 = _kicked(state0, scale=0.5)
    obstacles = default_obstacles()
    f_s = make_substep_fn(obj, cfg_semi)
    f_n = make_substep_fn(obj, cfg_newton)
    ss, sn = state0, state0
    for _ in range(20):
        ss, _ = f_s(ss, obstacles)
        sn, _ = f_n(sn, obstacles)
    np.testing.assert_allclose(
        np.asarray(ss.pos), np.asarray(sn.pos), rtol=1e-3, atol=5e-5
    )


@pytest.mark.parametrize("mat", MATS, ids=MAT_IDS)
@pytest.mark.parametrize(
    "overrides",
    [
        dict(auto_diff=False, use_explicit_method=True),
        dict(auto_diff=False, use_explicit_method=False, implicit_method=1,
             preconditioned=0),
        dict(auto_diff=False, use_explicit_method=False, implicit_method=1,
             preconditioned=0, integrator="newton",
             newton_hessian="decoupled"),
    ],
    ids=["explicit", "implicit-cg", "newton"],
)
def test_sharded_inelastic_matches_single_device(mat, overrides):
    """Round-5 gate lift: inelastic configs under shard_map (internal
    variables replicated, shard-local updates + all_gather) must match the
    single-device result, including the internal-variable trajectories."""
    from fem_tpu.parallel.sharding import (
        make_element_mesh, make_sharded_substep_fn,
    )

    cfg_all = default_sim_config(sim_count=2, **overrides)
    _, obj, state = make_2d_object(subdivisions=4, **mat)
    state = _kicked(state)
    obstacles = default_obstacles()
    mesh = make_element_mesh(8)

    single = make_substep_fn(obj, cfg_all)
    sharded = make_sharded_substep_fn(obj, cfg_all, mesh)
    s1, s2 = state, state
    for _ in range(5):
        s1, _ = single(s1, obstacles)
        s2, _ = sharded(s2, obstacles)
    np.testing.assert_allclose(
        np.asarray(s1.pos), np.asarray(s2.pos), rtol=1e-4, atol=1e-5
    )
    if s1.plastic_inv is not None:
        np.testing.assert_allclose(
            np.asarray(s1.plastic_inv), np.asarray(s2.plastic_inv),
            rtol=1e-4, atol=1e-5,
        )
    if s1.viscous_inv is not None:
        np.testing.assert_allclose(
            np.asarray(s1.viscous_inv), np.asarray(s2.viscous_inv),
            rtol=1e-4, atol=1e-5,
        )


def test_sharded_inelastic_3d():
    """3D inelastic under shard_map: element-sharded graph operator with the
    internal variables replicated (shard rows sliced by axis index)."""
    from fem_tpu.parallel.sharding import (
        make_element_mesh, make_sharded_substep_fn,
    )
    from tests.utils import default_sim_config_3d

    cfg_all = default_sim_config_3d(
        sim_count=2, implicit_method=1, preconditioned=0,
    )
    _, obj, state = make_3d_object(subdivisions=3, plastic_yield=0.02)
    state = _kicked(state, scale=0.4)
    obstacles = Obstacles.from_configs((), 3)
    mesh = make_element_mesh(8)

    single = make_substep_fn(obj, cfg_all)
    sharded = make_sharded_substep_fn(obj, cfg_all, mesh)
    s1, _ = single(state, obstacles)
    s2, _ = sharded(state, obstacles)
    np.testing.assert_allclose(
        np.asarray(s1.pos), np.asarray(s2.pos), rtol=1e-4, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(s1.plastic_inv), np.asarray(s2.plastic_inv),
        rtol=1e-4, atol=1e-5,
    )
