# coding=utf-8
"""``material="stable_neo_hookean"`` — the inversion-robust material.

The reference's Neo-Hookean (solver/explicit.py:23-28) NaNs the moment an
element inverts (unclamped log), and StVK has no volume barrier at all (the
documented 68k drop-test collapse).  The stable Neo-Hookean
extension is the polynomial core of Smith, de Goes & Kim, "Stable
Neo-Hookean Flesh Simulation" (TOG 2018): finite and smooth for ALL F
including inversion, rest-stable, consistent with linear elasticity at
F = I via the paper's λ' = λ + μ reparameterization.  These tests pin:

  * the cofactor algebra (cof = ∂J/∂F and its exact bilinear derivative);
  * analytic P / DP against autodiff oracles at normal AND inverted F;
  * rest stability and exact linear-elasticity consistency at F = I;
  * recovery from a fully inverted configuration under damped dynamics
    (where the reference NH is NaN from substep one);
  * the implicit decoupled-Hessian path staying finite from inverted starts.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fem_tpu.ops import smallmat as sm
from fem_tpu.ops.element import (
    deformation_gradients,
    energy_density,
    first_piola,
    first_piola_dp,
)
from fem_tpu.sim import make_frame_fn, make_substep_fn
from fem_tpu.utils.config import SimConfig
from tests.utils import (
    default_obstacles,
    default_sim_config,
    make_2d_object,
    two_tet_object,
)

MAT = "stable_neo_hookean"


def _rand_f(d, n=8, scale=0.4, seed=0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(
        np.eye(d) + scale * rng.standard_normal((n, d, d)), jnp.float32
    )


@pytest.mark.parametrize("dim", [2, 3])
def test_cofactor_identities(dim):
    """cof(M) = det(M)·M⁻ᵀ on invertible M; d_cofactor equals the jvp of the
    cofactor map; cof2 polarization: d_cofactor(M, M) = 2·cof(M) in 3D."""
    F = _rand_f(dim, seed=4)
    D = jnp.asarray(
        np.random.default_rng(5).standard_normal((8, dim, dim)), jnp.float32
    )
    cof = sm.cofactor(F)
    np.testing.assert_allclose(
        np.asarray(cof),
        np.asarray(sm.det(F)[..., None, None] * sm.mT(sm.inv(F))),
        rtol=1e-4, atol=1e-5,
    )
    _, jv = jax.jvp(sm.cofactor, (F,), (D,))
    np.testing.assert_allclose(
        np.asarray(sm.d_cofactor(F, D)), np.asarray(jv), rtol=1e-4, atol=1e-4
    )
    # Degree of the cofactor polynomial: linear in 2D, quadratic in 3D.
    scale = 2.0 if dim == 3 else 1.0
    np.testing.assert_allclose(
        np.asarray(sm.d_cofactor(F, F)), scale * np.asarray(cof),
        rtol=1e-5, atol=1e-5,
    )


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("inverted", [False, True])
def test_piola_matches_autodiff_even_inverted(dim, inverted):
    F = _rand_f(dim, seed=6)
    if inverted:
        F = F.at[:, 0].multiply(-1.0)  # det < 0 everywhere
        assert (np.asarray(sm.det(F)) < 0).all()
    mu, lam = 11.0, 6.0
    g = jax.grad(lambda f: jnp.sum(energy_density(f, mu, lam, MAT)))(F)
    P = first_piola(F, mu, lam, MAT)
    np.testing.assert_allclose(np.asarray(P), np.asarray(g), rtol=1e-4, atol=1e-3)
    assert np.isfinite(np.asarray(P)).all()
    D = jnp.asarray(
        np.random.default_rng(7).standard_normal(F.shape), jnp.float32
    )
    _, jv = jax.jvp(lambda f: first_piola(f, mu, lam, MAT), (F,), (D,))
    dp = first_piola_dp(F, D, mu, lam, MAT)
    np.testing.assert_allclose(np.asarray(dp), np.asarray(jv), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("dim", [2, 3])
def test_rest_stable_and_linear_consistent(dim):
    """φ(I) = 0, P(I) = 0, and DP(I)[D] equals the linear material's DP —
    the λ' = λ + μ reparameterization (Smith et al. §3.4) makes the model
    agree with linear elasticity to first order at the rest pose."""
    mu, lam = 13.0, 7.0
    eye = jnp.broadcast_to(jnp.eye(dim, dtype=jnp.float32), (1, dim, dim))
    assert abs(float(energy_density(eye, mu, lam, MAT)[0])) < 1e-6
    assert float(jnp.abs(first_piola(eye, mu, lam, MAT)).max()) < 1e-6
    D = jnp.asarray(
        np.random.default_rng(8).standard_normal((1, dim, dim)), jnp.float32
    )
    np.testing.assert_allclose(
        np.asarray(first_piola_dp(eye, D, mu, lam, MAT)),
        np.asarray(first_piola_dp(eye, D, mu, lam, "linear")),
        rtol=1e-5, atol=1e-5,
    )


def test_recovers_from_full_inversion_2d():
    """Mirror the whole body (every element det F = −1) and run damped
    explicit dynamics: forces stay finite on every substep and the body
    un-inverts (min det F > 0) — the reference NH is NaN from substep one
    on the same start."""
    _, obj, state = make_2d_object(subdivisions=3, center=(0.5, 0.5))
    obj_s = obj.replace(material=MAT, damping=40.0)
    cx = float(np.asarray(state.pos)[:, 0].mean())
    mirrored = np.asarray(state.pos).copy()
    mirrored[:, 0] = 2.0 * cx - mirrored[:, 0]
    state = state.replace(pos=jnp.asarray(mirrored))
    det0 = np.asarray(
        sm.det(deformation_gradients(state.pos, obj.element_indices, obj.ref_inv))
    )
    assert (det0 < 0).all()

    cfg = default_sim_config(
        auto_diff=False, use_explicit_method=True, sim_count=50,
        delta_time=1e-4,
    )
    frame = make_frame_fn(obj_s, cfg)
    obs = default_obstacles()
    s = state
    for _ in range(40):
        s, _ = frame(s, obs)
        assert np.isfinite(np.asarray(s.pos)).all()
    det_end = np.asarray(
        sm.det(deformation_gradients(s.pos, obj.element_indices, obj.ref_inv))
    )
    assert det_end.min() > 0.0, f"still inverted: min det F = {det_end.min()}"

    # The reference NH NaNs immediately from the same inverted start.
    nh_frame = make_frame_fn(obj.replace(damping=40.0), cfg)
    s_nh, _ = nh_frame(state, obs)
    assert not np.isfinite(np.asarray(s_nh.pos)).all()


def test_implicit_finite_from_inverted_start_3d():
    """Implicit CG with the stable-NH decoupled Hessian from an inverted
    start: the polynomial DP needs no clamp and the substep stays finite."""
    _, obj, state = two_tet_object()
    obj = obj.replace(material=MAT, damping=5.0)
    pos = np.asarray(state.pos).copy()
    pos[:, 0] *= -1.0  # mirror -> inverted elements
    state = state.replace(pos=jnp.asarray(pos))
    cfg = SimConfig(
        dim=3, delta_time=2e-4, sim_count=4, auto_diff=False,
        use_explicit_method=False, implicit_method=1, preconditioned=0,
        g_dir=(0.0, -1.0, 0.0), operator_mode="graph",
    )
    from fem_tpu.models.state import Obstacles

    s, _ = make_substep_fn(obj, cfg)(state, Obstacles.from_configs((), 3))
    assert np.isfinite(np.asarray(s.pos)).all()
    assert np.isfinite(np.asarray(s.vel)).all()


def test_energy_grows_with_compression_no_collapse():
    """The (J−1)² volume term resists total collapse: energy at J→0⁺ and at
    inverted J < 0 exceeds moderate-compression energy (StVK famously fails
    this — its energy DROPS again under extreme compression)."""
    mu, lam = 10.0, 20.0
    def phi_at(j):
        F = jnp.asarray(np.diag([j, 1.0, 1.0])[None], jnp.float32)
        return float(energy_density(F, mu, lam, MAT)[0])

    assert phi_at(0.05) > phi_at(0.5) > phi_at(0.9)
    assert phi_at(-0.5) > phi_at(0.5)
