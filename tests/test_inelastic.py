# coding=utf-8
"""Inelastic material extensions: multiplicative von-Mises plasticity and
generalized-Maxwell viscoelasticity (fem_tpu/ops/inelastic.py).

The reference is purely hyperelastic (solver/explicit.py:23-28); both models
add per-element internal variables updated once per substep."""

import jax.numpy as jnp
import numpy as np
import pytest

from fem_tpu.models.state import Obstacles
from fem_tpu.ops import smallmat as sm
from fem_tpu.ops.inelastic import (
    advance_internal,
    inelastic_energy_gradient,
    plastic_return_map,
    viscous_relax,
)
from fem_tpu.sim import make_substep_fn
from fem_tpu.utils.config import SimConfig, parse_config
from tests.utils import make_2d_object


def _cfg(**overrides):
    base = dict(
        dim=2, delta_time=1e-4, sim_count=10, auto_diff=False,
        use_explicit_method=True, implicit_method=1, preconditioned=0,
        g_dir=(0.0, 0.0), blocks=(),
    )
    base.update(overrides)
    return SimConfig(**base)


def _stretch(s, d=2):
    m = np.eye(d, dtype=np.float32)
    m[0, 0] = s
    return jnp.asarray(m[None])


def test_config_parse():
    cfg = parse_config(
        {"objects": [{"plastic_yield": 0.1, "viscous_mu": 500.0,
                      "viscous_tau": 0.05}]}
    )
    o = cfg.objects[0]
    assert o.plastic_yield == 0.1 and o.viscous_mu == 500.0
    assert parse_config({}).objects[0].plastic_yield == 0.0


def test_return_map_below_yield_is_identity():
    fe = _stretch(1.05)
    out, yielded = plastic_return_map(fe, 0.5)
    assert not bool(yielded[0])
    np.testing.assert_allclose(np.asarray(out)[0], np.asarray(fe)[0],
                               atol=1e-5)


def test_return_map_projects_onto_yield_surface():
    fe = _stretch(2.0)  # dev log strain norm = log(2)/sqrt(2) ≈ 0.49
    eps_y = 0.1
    out, yielded = plastic_return_map(fe, eps_y)
    assert bool(yielded[0])
    s = np.linalg.svd(np.asarray(out)[0], compute_uv=False)
    eps = np.log(s)
    dev = eps - eps.mean()
    np.testing.assert_allclose(np.linalg.norm(dev), eps_y, rtol=1e-4)
    # Isochoric flow: the volumetric part is untouched.
    np.testing.assert_allclose(eps.sum(), np.log(2.0), rtol=1e-4)


def test_viscous_relax_decay():
    fe = _stretch(1.5)
    out = viscous_relax(fe, dt=0.05, tau=0.05)  # one time constant
    s = np.linalg.svd(np.asarray(out)[0], compute_uv=False)
    np.testing.assert_allclose(
        np.log(s).max(), np.log(1.5) * np.exp(-1.0), rtol=1e-4
    )


def test_huge_yield_matches_pure_elastic():
    """With an unreachable yield strain the plastic body must track the
    plain elastic body (F_p stays I; effective ref_inv = ref_inv·I)."""
    cfg = _cfg(g_dir=(0.0, -1.0))
    _, obj_e, st_e = make_2d_object()
    _, obj_p, st_p = make_2d_object(plastic_yield=1e6)
    assert st_p.plastic_inv is not None and st_e.plastic_inv is None
    obstacles = Obstacles.from_configs((), 2)
    fn_e, fn_p = make_substep_fn(obj_e, cfg), make_substep_fn(obj_p, cfg)
    for _ in range(100):
        st_e, _ = fn_e(st_e, obstacles)
        st_p, _ = fn_p(st_p, obstacles)
    np.testing.assert_allclose(
        np.asarray(st_e.pos), np.asarray(st_p.pos), atol=1e-5
    )
    # F_p never moved.
    eye = np.broadcast_to(np.eye(2), np.asarray(st_p.plastic_inv).shape)
    np.testing.assert_allclose(np.asarray(st_p.plastic_inv), eye, atol=1e-6)


@pytest.mark.parametrize("method", ["explicit", "implicit"])
def test_plastic_permanent_deformation(method):
    """Squash a 2D block far beyond yield with a moving pin, release-free
    relax: the body must NOT return to its rest shape (permanent set) and
    the residual elastic strain must sit at/below the yield surface."""
    mat = dict(plastic_yield=0.05, damping=80.0, E=4e4)
    cfg = _cfg(use_explicit_method=(method == "explicit"))
    _, obj, state = make_2d_object(**mat)
    obstacles = Obstacles.from_configs((), 2)
    fn = make_substep_fn(obj, cfg)
    # Phase 1: squash to 60% height kinematically and let the internal
    # state accommodate (the return map is rate-independent — one update
    # at the held configuration absorbs the super-yield deformation).
    rng_pos = np.asarray(state.pos)
    squash = rng_pos.copy()
    squash[:, 1] = (
        squash[:, 1].min() + 0.6 * (squash[:, 1] - squash[:, 1].min())
    )
    state = state.replace(pos=jnp.asarray(squash.astype(np.float32)))
    state = advance_internal(obj, state, cfg.delta_time)
    fp_after_flow = np.asarray(state.plastic_inv)
    assert np.abs(fp_after_flow - np.eye(2)).max() > 0.1  # flowed
    # Phase 2: release (heavily damped so the rebound cannot re-yield).
    for _ in range(400):
        state, _ = fn(state, obstacles)
    p = np.asarray(state.pos)
    assert np.all(np.isfinite(p))
    # Permanent DEVIATORIC set with elastic volume recovery (isochoric
    # flow): the deviator (0.255, −0.255) flowed to the yield surface, the
    # volumetric −0.51 stayed elastic — so the stress-free end state is
    # F ≈ F_p = diag(e^+0.205, e^−0.205): squat AND widened, at full
    # volume.  Height ~0.2·0.82 ≈ 0.165 (+elastic ≤ yield), width ~0.246.
    rest_h = rng_pos[:, 1].max() - rng_pos[:, 1].min()
    rest_w = rng_pos[:, 0].max() - rng_pos[:, 0].min()
    h = p[:, 1].max() - p[:, 1].min()
    w = p[:, 0].max() - p[:, 0].min()
    assert h < 0.92 * rest_h  # permanent set (elastic would recover ~100%)
    assert w > 1.10 * rest_w  # volume-preserving widening
    # Residual elastic deviatoric strain sits at/below the yield surface.
    from fem_tpu.ops.element import deformation_gradients
    from fem_tpu.ops.inelastic import effective_ref_inv

    fe = np.asarray(
        deformation_gradients(
            state.pos, obj.element_indices,
            effective_ref_inv(obj.ref_inv, state.plastic_inv),
        )
    )
    s = np.linalg.svd(fe, compute_uv=False)
    eps = np.log(np.maximum(s, 1e-6))
    dev = eps - eps.mean(axis=-1, keepdims=True)
    assert np.linalg.norm(dev, axis=-1).max() < 0.06  # ≈ yield 0.05


def test_viscoelastic_stress_relaxation():
    """Hold a stretched configuration fixed: the viscous branch force
    decays toward the base-material force with time constant τ."""
    mat = dict(viscous_mu=2e4, viscous_tau=0.02, damping=0.0)
    _, obj, state = make_2d_object(**mat)
    _, obj_base, _ = make_2d_object(damping=0.0)
    # Small-strain regime so the branch force is ~linear in the branch log
    # strain and the force ratio tracks the strain decay exp(−t/τ).
    stretched = np.asarray(state.pos)
    center = stretched.mean(0, keepdims=True)
    stretched = center + (stretched - center) * np.array([[1.05, 1.0]])
    pos = jnp.asarray(stretched.astype(np.float32))
    state = state.replace(pos=pos)
    dt = 1e-3

    def branch_force_norm(st):
        g_total = inelastic_energy_gradient(obj, st, pos)
        from fem_tpu.solvers.explicit import analytic_energy_gradient

        g_base = analytic_energy_gradient(obj_base, pos)
        return float(jnp.linalg.norm(g_total - g_base))

    f0 = branch_force_norm(state)
    # Relax the internal variable at FIXED positions for 1τ and 3τ.
    st = state
    for _ in range(20):  # 20 · 1e-3 = 0.02 s = 1τ
        st = advance_internal(obj, st, dt)
    f1 = branch_force_norm(st)
    for _ in range(40):  # 3τ total
        st = advance_internal(obj, st, dt)
    f3 = branch_force_norm(st)
    assert f0 > 0.0
    np.testing.assert_allclose(f1 / f0, np.exp(-1.0), rtol=0.1)
    assert f3 < 0.1 * f0  # ~e^-3 ≈ 0.05


def test_viscoelastic_dissipates_oscillation():
    """Free vibration decays faster with a Maxwell branch."""
    from fem_tpu.ops.element import total_energy

    def run(**mat):
        cfg = _cfg()
        _, obj, state = make_2d_object(damping=0.0, **mat)
        rng = np.random.default_rng(0)
        state = state.replace(
            vel=jnp.asarray(
                0.3 * rng.standard_normal(state.pos.shape).astype(np.float32)
            )
        )
        obstacles = Obstacles.from_configs((), 2)
        fn = make_substep_fn(obj, cfg)
        for _ in range(400):
            state, _ = fn(state, obstacles)
        u = total_energy(
            state.pos, obj.element_indices, obj.ref_inv, obj.volume,
            obj.mu, obj.s_lambda, obj.material,
        )
        ke = 0.5 * jnp.sum(obj.mass[:, None] * state.vel ** 2)
        return float(u + ke)

    e_visc = run(viscous_mu=2e4, viscous_tau=5e-3)
    e_plain = run()
    assert np.isfinite(e_visc)
    assert e_visc < 0.7 * e_plain


def test_implicit_viscoelastic_runs_and_relaxes():
    cfg = _cfg(use_explicit_method=False, g_dir=(0.0, -1.0))
    _, obj, state = make_2d_object(viscous_mu=1e4, viscous_tau=0.01)
    obstacles = Obstacles.from_configs((), 2)
    fn = make_substep_fn(obj, cfg)
    for _ in range(100):
        state, aux = fn(state, obstacles)
    assert np.all(np.isfinite(np.asarray(state.pos)))
    fv = np.asarray(state.viscous_inv)
    assert np.all(np.isfinite(fv))


def test_checkpoint_roundtrip_with_internal_state(tmp_path):
    from fem_tpu.utils.io import load_checkpoint, save_checkpoint

    cfg = _cfg(g_dir=(0.0, -1.0))
    _, obj, state = make_2d_object(plastic_yield=0.03, viscous_mu=1e4)
    obstacles = Obstacles.from_configs((), 2)
    fn = make_substep_fn(obj, cfg)
    for _ in range(30):
        state, _ = fn(state, obstacles)
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, state, 3, 0.05)
    loaded, step, vt = load_checkpoint(path)
    assert step == 3
    np.testing.assert_array_equal(
        np.asarray(loaded.plastic_inv), np.asarray(state.plastic_inv)
    )
    np.testing.assert_array_equal(
        np.asarray(loaded.viscous_inv), np.asarray(state.viscous_inv)
    )


def test_loud_gates():
    _, obj, state = make_2d_object(plastic_yield=0.05)
    cfg_jac = _cfg(use_explicit_method=False, implicit_method=0)
    fn_j = make_substep_fn(obj, cfg_jac)
    obstacles = Obstacles.from_configs((), 2)
    with pytest.raises(ValueError, match="CG"):
        fn_j(state, obstacles)
