# coding=utf-8
"""Implicit path: matrix-free operator vs dense assembly, CG vs scipy,
Jacobi semantics (SURVEY §4: mirrors the reference's numpy/scipy playground
solver/implicit.py:441-557 as a real suite)."""

import jax.numpy as jnp
import numpy as np

from fem_tpu.models.state import dense_system_matrix
from fem_tpu.solvers.implicit import (
    conjugate_gradient,
    diagonal_blocks,
    implicit_rhs,
    implicit_velocity_solve,
    jacobi_solve,
    make_system_apply,
    make_system_apply_t,
)
from fem_tpu.ops.element import hessian_blocks
from fem_tpu.utils.config import CONJUGATE_GRADIENT_METHOD, JACOBI_METHOD
from tests.utils import make_2d_object, two_tet_object

DT = 5e-4


def _perturbed(state, scale, seed=5):
    rng = np.random.default_rng(seed)
    noise = rng.normal(scale=scale, size=state.pos.shape).astype(np.float32)
    vel = rng.normal(scale=0.1, size=state.pos.shape).astype(np.float32)
    return state.replace(
        pos=state.pos + jnp.asarray(noise), vel=jnp.asarray(vel)
    )


def _hessian(obj, state):
    return hessian_blocks(
        state.pos, obj.element_indices, obj.ref_inv, obj.volume,
        obj.mu, obj.s_lambda,
    )


def test_matrix_free_apply_matches_dense():
    for maker, scale in ((make_2d_object, 0.004), (two_tet_object, 0.03)):
        cfg, obj, state = maker()
        state = _perturbed(state, scale)
        A = dense_system_matrix(obj, state, DT)
        apply_a = make_system_apply(obj, _hessian(obj, state), DT)
        rng = np.random.default_rng(1)
        x = rng.normal(size=(obj.particle_cnt, obj.dim)).astype(np.float32)
        got = np.asarray(apply_a(jnp.asarray(x))).reshape(-1)
        expect = A @ x.reshape(-1)
        np.testing.assert_allclose(got, expect, rtol=2e-4, atol=2e-5)


def test_transpose_apply_matches_dense_transpose():
    cfg, obj, state = make_2d_object(subdivisions=3)
    state = _perturbed(state, 0.004)
    A = dense_system_matrix(obj, state, DT)
    apply_at = make_system_apply_t(obj, _hessian(obj, state), DT)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(obj.particle_cnt, obj.dim)).astype(np.float32)
    got = np.asarray(apply_at(jnp.asarray(x))).reshape(-1)
    np.testing.assert_allclose(got, A.T @ x.reshape(-1), rtol=2e-4, atol=2e-5)


def test_diagonal_blocks_match_dense():
    cfg, obj, state = two_tet_object()
    state = _perturbed(state, 0.03)
    A = dense_system_matrix(obj, state, DT)
    diag = np.asarray(diagonal_blocks(obj, _hessian(obj, state), DT))
    d = obj.dim
    for p in range(obj.particle_cnt):
        np.testing.assert_allclose(
            diag[p], A[p * d : (p + 1) * d, p * d : (p + 1) * d],
            rtol=1e-4, atol=1e-6,
        )


def test_rhs_matches_dense_reference_semantics():
    """b = v + dt·M⁻¹·f_elastic (implicit.py:65-107) recomputed densely."""
    cfg, obj, state = two_tet_object()
    state = _perturbed(state, 0.03)
    b = np.asarray(implicit_rhs(obj, state, DT))
    pos = np.asarray(state.pos, np.float64)
    idx = np.asarray(obj.element_indices)
    mass = np.asarray(obj.mass, np.float64)
    expect = np.asarray(state.vel, np.float64).copy()
    for e in range(obj.element_cnt):
        X = np.stack([pos[idx[e, j + 1]] - pos[idx[e, 0]] for j in range(3)], 1)
        R_inv = np.asarray(obj.ref_inv, np.float64)[e]
        F = X @ R_inv
        F_inv = np.linalg.inv(F)
        V = float(obj.volume[e])
        P = (
            obj.mu * F
            - obj.mu * F_inv.T
            + obj.s_lambda / 2 * np.log(np.linalg.det(F.T @ F)) * F_inv.T
        )
        force = -V * P @ R_inv.T
        f0 = np.zeros(3)
        for j in range(3):
            fj = force[:, j]
            f0 -= fj
            expect[idx[e, j + 1]] += DT / mass[idx[e, j + 1]] * fj
        expect[idx[e, 0]] += DT / mass[idx[e, 0]] * f0
    np.testing.assert_allclose(b, expect, rtol=1e-3, atol=1e-5)


def test_cg_solves_dense_system():
    """Matrix-free preconditioned CG solution vs numpy dense solve."""
    cfg, obj, state = make_2d_object(subdivisions=3)
    state = _perturbed(state, 0.004)
    A = dense_system_matrix(obj, state, DT)
    b = np.asarray(implicit_rhs(obj, state, DT))
    x_direct = np.linalg.solve(A, b.reshape(-1)).reshape(b.shape)

    # The reference CG stops on an *absolute* squared-residual tolerance of
    # 1e-5 (implicit.py:341), so the solution accuracy contract is
    # ||rhs − Op·x|| ≲ sqrt(1e-5) ≈ 3e-3 — compare at that scale.
    new_state, aux = implicit_velocity_solve(
        obj, state, DT, CONJUGATE_GRADIENT_METHOD, preconditioned=1
    )
    np.testing.assert_allclose(
        np.asarray(new_state.vel), x_direct, rtol=5e-3, atol=5e-3
    )
    assert int(aux.iterations) > 0
    assert float(aux.residual) <= 1e-5

    # Non-preconditioned path solves the same system.
    new_state2, _ = implicit_velocity_solve(
        obj, state, DT, CONJUGATE_GRADIENT_METHOD, preconditioned=0
    )
    np.testing.assert_allclose(
        np.asarray(new_state2.vel), x_direct, rtol=5e-3, atol=5e-3
    )


def test_cg_on_known_spd_system():
    """CG semantics (x0, tol, caps) on a small SPD system vs scipy — the
    analogue of the reference's test() (implicit.py:538-557)."""
    from scipy.sparse.linalg import cg as scipy_cg

    rng = np.random.default_rng(42)
    n = 12
    m = rng.normal(size=(n, n))
    A = (m @ m.T + n * np.eye(n)).astype(np.float32)
    b = rng.normal(size=(n,)).astype(np.float32)

    op = lambda v: jnp.asarray(A) @ v
    res = conjugate_gradient(op, jnp.asarray(b), x0=jnp.asarray(b))
    x_scipy, info = scipy_cg(A.astype(np.float64), b.astype(np.float64))
    assert info == 0
    np.testing.assert_allclose(np.asarray(res.x), x_scipy, rtol=1e-3, atol=1e-4)


def test_jacobi_solves_system():
    cfg, obj, state = make_2d_object(subdivisions=3)
    state = _perturbed(state, 0.002)
    A = dense_system_matrix(obj, state, DT)
    b = np.asarray(implicit_rhs(obj, state, DT))
    x_direct = np.linalg.solve(A, b.reshape(-1)).reshape(b.shape)
    new_state, aux = implicit_velocity_solve(
        obj, state, DT, JACOBI_METHOD, preconditioned=0
    )
    # The reference Jacobi stops on error increase; with dt=5e-4 the system is
    # near-identity and converges tightly.
    np.testing.assert_allclose(
        np.asarray(new_state.vel), x_direct, rtol=5e-3, atol=5e-4
    )
    # past_x persisted for the next step's relaxation anchor.
    np.testing.assert_allclose(
        np.asarray(new_state.jacobi_past_x), np.asarray(new_state.vel)
    )


def test_mxu_operator_matches_graph():
    """The dense edge-matrix operator Sᵀ(K∘(Sx)) must match the graph
    gather/scatter operator exactly (same linear map, dense execution)."""
    import jax.numpy as jnp

    from tests.utils import attach_edge_matrix

    for maker, scale in ((make_2d_object, 0.004), (two_tet_object, 0.03)):
        cfg, obj, state = maker()
        obj = attach_edge_matrix(obj)
        state = _perturbed(state, scale)
        assert obj.edge_matrix is not None
        s1, _ = implicit_velocity_solve(
            obj, state, DT, 1, 1, operator_mode="graph"
        )
        s2, _ = implicit_velocity_solve(
            obj, state, DT, 1, 1, operator_mode="mxu"
        )
        np.testing.assert_allclose(
            np.asarray(s2.vel), np.asarray(s1.vel), rtol=1e-4, atol=1e-6
        )


def test_jacobi_zero_diagonal_branch():
    """|a_ii| < 1e-6 zeroes that component instead of dividing
    (implicit.py:400-401)."""
    import jax.numpy as jnp

    a = jnp.asarray(np.diag([1.0, 1e-9]).astype(np.float32))
    diag = jnp.asarray(
        np.array([[[1.0]], [[1e-9]]], np.float32)
    )  # (N=2, d=1, d=1)
    b = jnp.asarray(np.array([[1.0], [1.0]], np.float32))
    past = jnp.zeros((2, 1))
    res = jacobi_solve(lambda v: a @ v, diag, b, past)
    x = np.asarray(res.x)
    assert x[1, 0] == 0.0  # degenerate diagonal → zeroed every sweep
    # Healthy row relaxes toward b/a until the degenerate row's constant
    # residual makes the error non-monotone and the rollback stops it.
    assert 0.7 < x[0, 0] <= 1.0
    assert int(res.iterations) >= 1


def _hand_serial_sweep(A, b, x, past, omega=0.75):
    """Independent numpy transcription of the reference's serial in-place
    sweep (implicit.py:391-404): rows update in order, row i's residual uses
    rows j<i already updated and the full OLD x_i, only the scalar diagonal
    added back, relaxation anchored on `past`."""
    n, d = b.shape
    xf = x.reshape(-1).copy().astype(np.float64)
    Af, bf, pf = A.astype(np.float64), b.reshape(-1), past.reshape(-1)
    for i in range(n):
        ax = Af[i * d:(i + 1) * d] @ xf
        for k in range(d):
            r = i * d + k
            a_ii = Af[r, r]
            if abs(a_ii) < 1e-6:
                xf[r] = 0.0
            else:
                xf[r] = omega * (bf[r] - ax[k] + a_ii * xf[r]) / a_ii \
                    + (1 - omega) * pf[r]
    return xf.reshape(n, d)


def test_jacobi_serial_sweep_semantics():
    """One serial sweep must match the hand-rolled Gauss–Seidel-style update,
    and must genuinely differ from the snapshot sweep (ordering effect)."""
    from fem_tpu.solvers.implicit import jacobi_solve_serial

    rng = np.random.default_rng(7)
    n, d = 5, 2
    m = rng.normal(size=(n * d, n * d))
    A = (0.05 * (m @ m.T) + np.eye(n * d)).astype(np.float32)
    b = rng.normal(size=(n, d)).astype(np.float32)
    past = rng.normal(size=(n, d)).astype(np.float32) * 0.1

    res = jacobi_solve_serial(
        jnp.asarray(A), jnp.asarray(b), jnp.asarray(past), max_iter=1
    )
    expect = _hand_serial_sweep(A, b, 0.5 * b, past)
    assert int(res.iterations) == 1
    np.testing.assert_allclose(np.asarray(res.x), expect, rtol=1e-5, atol=1e-6)

    # Snapshot sweep from the same start differs (rows read the old iterate).
    diag_blocks = jnp.asarray(
        np.stack([np.diag(np.diag(A)[i * d:(i + 1) * d]) for i in range(n)])
    )
    snap = jacobi_solve(
        lambda v: (jnp.asarray(A) @ v.reshape(-1)).reshape(n, d),
        diag_blocks, jnp.asarray(b), jnp.asarray(past), max_iter=1,
    )
    assert np.abs(np.asarray(snap.x) - np.asarray(res.x)).max() > 1e-5


def test_jacobi_serial_zero_diagonal_branch():
    """|a_ii| < 1e-6 zeroes that component in the serial sweep too
    (implicit.py:400-401)."""
    from fem_tpu.solvers.implicit import jacobi_solve_serial

    A = jnp.asarray(np.diag([1.0, 1e-9]).astype(np.float32))
    b = jnp.asarray(np.array([[1.0], [1.0]], np.float32))  # N=2, d=1
    past = jnp.zeros((2, 1))
    res = jacobi_solve_serial(A, b, past)
    x = np.asarray(res.x)
    assert x[1, 0] == 0.0
    assert 0.7 < x[0, 0] <= 1.0


def test_jacobi_serial_matches_solution():
    """On the real FEM system the serial sweep still converges to the direct
    solve (same fixed point, different path than snapshot)."""
    cfg, obj, state = make_2d_object(subdivisions=3)
    state = _perturbed(state, 0.002)
    A = dense_system_matrix(obj, state, DT)
    b = np.asarray(implicit_rhs(obj, state, DT))
    x_direct = np.linalg.solve(A, b.reshape(-1)).reshape(b.shape)
    new_state, aux = implicit_velocity_solve(
        obj, state, DT, JACOBI_METHOD, preconditioned=0, jacobi_sweep="serial"
    )
    np.testing.assert_allclose(
        np.asarray(new_state.vel), x_direct, rtol=5e-3, atol=5e-4
    )


def test_jacobi_serial_sparse_matches_dense():
    """The O(E) block-sparse serial sweep (jacobi_solve_serial_sparse — the
    live path in implicit_velocity_solve) must match the dense row-scan
    sweep (jacobi_solve_serial) on the real FEM system: identical
    Gauss–Seidel read-order semantics, float-roundoff-level agreement."""
    from fem_tpu.solvers.dense import assemble_dense_system
    from fem_tpu.ops.element import hessian_blocks
    from fem_tpu.solvers.implicit import (
        jacobi_solve_serial,
        jacobi_solve_serial_sparse,
        sparse_system_rows,
    )

    for maker, scale in ((make_2d_object, 0.004), (two_tet_object, 0.03)):
        cfg, obj, state = maker()
        state = _perturbed(state, scale)
        rng = np.random.default_rng(11)
        past = jnp.asarray(
            rng.normal(scale=0.01, size=state.pos.shape).astype(np.float32)
        )
        K = hessian_blocks(
            state.pos, obj.element_indices, obj.ref_inv, obj.volume,
            obj.mu, obj.s_lambda,
        )
        b = implicit_rhs(obj, state, DT)

        # The sparse rows must reproduce the dense system entry-for-entry.
        a_dense = assemble_dense_system(obj, K, DT)
        rows_a = sparse_system_rows(obj, K, DT)
        n, d = state.pos.shape
        a_from_sparse = np.zeros((n, n, d, d), np.float32)
        nb = np.asarray(obj.jacobi_nb)
        for i in range(n):
            for k, j in enumerate(nb[i]):
                if j >= 0:
                    a_from_sparse[i, j] = np.asarray(rows_a[i, k])
        a_from_sparse = a_from_sparse.transpose(0, 2, 1, 3).reshape(
            n * d, n * d
        )
        np.testing.assert_allclose(
            a_from_sparse, np.asarray(a_dense), rtol=1e-6, atol=1e-7
        )

        res_d = jacobi_solve_serial(a_dense, b, past, max_iter=50)
        res_s = jacobi_solve_serial_sparse(
            obj.jacobi_nb, rows_a, b, past, max_iter=50
        )
        assert int(res_s.iterations) == int(res_d.iterations)
        np.testing.assert_allclose(
            np.asarray(res_s.x), np.asarray(res_d.x), rtol=1e-5, atol=1e-6
        )


def test_energy_rotation_invariance():
    """Neo-Hookean and StVK energies are invariant under rigid rotation of F
    (property test; linear elasticity is knowingly not)."""
    from fem_tpu.ops.element import energy_density
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    F = jnp.asarray(
        (np.eye(3) + 0.1 * rng.normal(size=(5, 3, 3))).astype(np.float32)
    )
    theta = 0.7
    c, s = np.cos(theta), np.sin(theta)
    R = jnp.asarray(
        np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    )
    RF = jnp.einsum("ij,ejk->eik", R, F)
    for material in ("neo_hookean", "stvk"):
        phi = np.asarray(energy_density(F, 1e4, 1e4, material))
        phi_r = np.asarray(energy_density(RF, 1e4, 1e4, material))
        np.testing.assert_allclose(phi_r, phi, rtol=1e-4, atol=1e-3)


def test_jacobi_rollback_on_divergence():
    """On a non-dominant system where the first sweep increases the residual,
    jacobi returns the stale past_x (rollback semantics, implicit.py:257-259)."""
    A = jnp.asarray(np.array([[1.0, 4.0], [5.0, 1.0]], np.float32))
    diag = jnp.asarray(
        np.array([[[1.0]], [[1.0]]], np.float32)
    )  # (N=2, d=1, d=1)
    b = jnp.asarray(np.array([[1.0], [1.0]], np.float32))
    past = jnp.asarray(np.array([[7.0], [9.0]], np.float32))
    op = lambda v: A @ v
    res = jacobi_solve(op, diag, b, past)
    # Divergent: after some iterations error grows, x rolls back to the last
    # cached iterate (or the stale `past` if the very first sweep diverged).
    assert bool(jnp.all(jnp.isfinite(res.x)))
    assert int(res.iterations) < 20000
