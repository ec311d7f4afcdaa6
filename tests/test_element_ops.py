# coding=utf-8
"""Element kernels: rest-pose identities, autodiff-vs-analytic parity,
translation invariance (SURVEY §4 test strategy)."""

import jax
import jax.numpy as jnp
import numpy as np

from fem_tpu.ops.assembly import element_contrib_full, segment_assemble
from fem_tpu.ops.element import (
    deformation_gradients,
    element_energies,
    explicit_grad_columns,
    hessian_blocks,
    implicit_force_columns,
    total_energy,
)
from fem_tpu.solvers.explicit import (
    analytic_energy_gradient,
    autodiff_energy_gradient,
)
from tests.utils import make_2d_object, single_tet_object, two_tet_object


def _perturbed(state, scale=0.004, seed=3):
    # Small relative to the 2D grid spacing (0.05) so no element inverts —
    # log(det F) of an inverted element is NaN by design (explicit.py:24).
    rng = np.random.default_rng(seed)
    noise = rng.normal(scale=scale, size=state.pos.shape).astype(np.float32)
    return state.replace(pos=state.pos + jnp.asarray(noise))


def test_rest_pose_F_identity_zero_energy_zero_force():
    for maker in (make_2d_object, single_tet_object, two_tet_object):
        cfg, obj, state = maker()
        F = deformation_gradients(state.pos, obj.element_indices, obj.ref_inv)
        d = obj.dim
        np.testing.assert_allclose(
            np.asarray(F), np.broadcast_to(np.eye(d), F.shape), atol=1e-5
        )
        U = total_energy(
            state.pos, obj.element_indices, obj.ref_inv, obj.volume,
            obj.mu, obj.s_lambda,
        )
        assert abs(float(U)) < 1e-4
        g = analytic_energy_gradient(obj, state.pos)
        np.testing.assert_allclose(np.asarray(g), 0.0, atol=2e-2)


def test_autodiff_matches_analytic_gradient():
    """jax.grad of the energy == analytic Piola gradient (the reference ships
    both formulations precisely so they can be compared — explicit.py:25 vs
    explicit_auto_diff.py:26-28)."""
    for maker in (make_2d_object, single_tet_object, two_tet_object):
        cfg, obj, state = maker()
        state = _perturbed(state)
        g_analytic = np.asarray(analytic_energy_gradient(obj, state.pos))
        g_auto = np.asarray(autodiff_energy_gradient(obj, state.pos))
        scale = max(1.0, np.abs(g_analytic).max())
        np.testing.assert_allclose(
            g_auto / scale, g_analytic / scale, atol=2e-5
        )


def test_gradient_matches_finite_differences():
    cfg, obj, state = single_tet_object()
    state = _perturbed(state, scale=0.05)
    pos64 = np.asarray(state.pos, np.float64)

    def energy_np(p):
        return float(
            total_energy(
                jnp.asarray(p, jnp.float32), obj.element_indices, obj.ref_inv,
                obj.volume, obj.mu, obj.s_lambda,
            )
        )

    g = np.asarray(analytic_energy_gradient(obj, state.pos))
    eps = 1e-3
    for i in [0, 2]:
        for k in range(3):
            dp = pos64.copy()
            dp[i, k] += eps
            dm = pos64.copy()
            dm[i, k] -= eps
            fd = (energy_np(dp) - energy_np(dm)) / (2 * eps)
            assert abs(fd - g[i, k]) < 5e-2 * max(1.0, abs(fd))


def test_translation_invariance():
    """Rigid translation changes nothing: F, energy, forces identical."""
    cfg, obj, state = two_tet_object()
    state = _perturbed(state)
    shift = jnp.asarray(np.array([0.13, -0.07, 0.21], np.float32))
    g1 = np.asarray(analytic_energy_gradient(obj, state.pos))
    g2 = np.asarray(analytic_energy_gradient(obj, state.pos + shift[None, :]))
    np.testing.assert_allclose(g1, g2, atol=1e-3)


def test_force_rows_sum_to_zero():
    """Assembled gradient sums to zero over particles (momentum conservation;
    consequence of the −Σ columns pattern, explicit.py:42-49)."""
    cfg, obj, state = make_2d_object()
    state = _perturbed(state)
    g = np.asarray(analytic_energy_gradient(obj, state.pos))
    np.testing.assert_allclose(g.sum(axis=0), 0.0, atol=1e-2)


def test_implicit_force_equals_minus_gradient_when_uninverted():
    """The implicit RHS force (λ/2·log det(FᵀF) form, implicit.py:87) equals
    −analytic gradient when det F > 0."""
    cfg, obj, state = make_2d_object()
    state = _perturbed(state)  # small: must not invert any element
    cols_g = explicit_grad_columns(
        state.pos, obj.element_indices, obj.ref_inv, obj.volume,
        obj.mu, obj.s_lambda,
    )
    cols_f = implicit_force_columns(
        state.pos, obj.element_indices, obj.ref_inv, obj.volume,
        obj.mu, obj.s_lambda,
    )
    cf, cg = np.asarray(cols_f), np.asarray(cols_g)
    assert np.isfinite(cg).all(), "perturbation inverted an element"
    # The two expressions (λ·log det F vs λ/2·log det FᵀF) are equal exactly
    # but round differently in f32; compare at scale-relative tolerance.
    np.testing.assert_allclose(cf, -cg, rtol=1e-3, atol=1e-4 * np.abs(cg).max())


def test_phi_sized_by_element_count():
    cfg, obj, state = single_tet_object()
    phi = element_energies(
        state.pos, obj.element_indices, obj.ref_inv, obj.volume,
        obj.mu, obj.s_lambda,
    )
    assert phi.shape == (obj.element_cnt,)


def test_segment_assembly_matches_loop():
    rng = np.random.default_rng(0)
    cfg, obj, state = make_2d_object(subdivisions=3)
    e, d = obj.element_cnt, obj.dim
    cols = rng.normal(size=(e, d, d)).astype(np.float32)
    out = np.asarray(
        segment_assemble(
            element_contrib_full(jnp.asarray(cols)),
            obj.element_indices,
            obj.particle_cnt,
        )
    )
    expect = np.zeros((obj.particle_cnt, d), np.float64)
    idx = np.asarray(obj.element_indices)
    for ei in range(e):
        f0 = np.zeros(d)
        for j in range(d):
            expect[idx[ei, j + 1]] += cols[ei, :, j]
            f0 -= cols[ei, :, j]
        expect[idx[ei, 0]] += f0
    np.testing.assert_allclose(out, expect, rtol=1e-4, atol=1e-5)


def test_gather_assembly_matches_segment_assembly():
    """The gather-plan assembly (deterministic sums) must equal segment-sum —
    including the two-tier split form (ops/assembly.split_two_tier)."""
    from fem_tpu.ops.assembly import (
        build_gather_plan,
        gather_assemble,
        split_two_tier,
    )

    rng = np.random.default_rng(4)
    for maker in (make_2d_object, two_tet_object):
        cfg, obj, state = maker()
        e, d = obj.element_cnt, obj.dim
        contrib = jnp.asarray(
            rng.normal(size=(e, d + 1, d)).astype(np.float32)
        )
        seg = segment_assemble(contrib, obj.element_indices, obj.particle_cnt)
        plan = build_gather_plan(
            np.asarray(obj.element_indices), obj.particle_cnt
        )
        valence = np.bincount(
            np.asarray(obj.element_indices).reshape(-1),
            minlength=obj.particle_cnt,
        )
        lo, hi, out_ids = split_two_tier(plan, valence)
        np.testing.assert_array_equal(lo, np.asarray(obj.gather_idx))
        if hi is None:
            assert obj.gather_hi is None and obj.gather_out is None
        else:
            np.testing.assert_array_equal(hi, np.asarray(obj.gather_hi))
            np.testing.assert_array_equal(out_ids, np.asarray(obj.gather_out))
            # Every non-sentinel row consumed exactly once across tiers.
            sent = e * (d + 1)
            rows = np.concatenate([lo.reshape(-1), hi.reshape(-1)])
            rows = rows[rows != sent]
            assert rows.size == np.unique(rows).size == (
                plan != sent
            ).sum()
        gat = gather_assemble(
            contrib, obj.gather_idx, obj.gather_hi, obj.gather_out
        )
        np.testing.assert_allclose(
            np.asarray(gat), np.asarray(seg), rtol=1e-5, atol=1e-6
        )
        # The single-tier full plan agrees too.
        gat_full = gather_assemble(contrib, jnp.asarray(plan))
        np.testing.assert_allclose(
            np.asarray(gat_full), np.asarray(seg), rtol=1e-5, atol=1e-6
        )


def test_hessian_blocks_match_direct_formula():
    cfg, obj, state = single_tet_object()
    state = _perturbed(state, scale=0.03)
    K = np.asarray(
        hessian_blocks(
            state.pos, obj.element_indices, obj.ref_inv, obj.volume,
            obj.mu, obj.s_lambda,
        )
    )[0]
    # Recompute in numpy float64 following implicit.py:131-147 literally.
    pos = np.asarray(state.pos, np.float64)
    idx = np.asarray(obj.element_indices)[0]
    X = np.stack([pos[idx[j + 1]] - pos[idx[0]] for j in range(3)], axis=1)
    R_inv = np.asarray(obj.ref_inv, np.float64)[0]
    F = X @ R_inv
    F_inv = np.linalg.inv(F)
    log_j = np.log(max(np.linalg.det(F), 1e-4))
    V = float(obj.volume[0])
    mu, lam = obj.mu, obj.s_lambda
    dF = np.eye(3) @ R_inv
    blk = (
        mu * dF
        + (mu - lam * log_j) * F_inv.T @ dF.T @ F_inv.T
        + lam * np.trace(F_inv @ dF) * F_inv.T
    )
    expect = -V * blk @ R_inv.T
    np.testing.assert_allclose(K, expect, rtol=1e-3, atol=1e-5)
