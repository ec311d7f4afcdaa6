# coding=utf-8
"""Closed-form small-matrix ops vs numpy linalg."""

import jax.numpy as jnp
import numpy as np

from fem_tpu.ops import smallmat as sm


def _rand(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=shape).astype(np.float32)


def test_det_inv_2d():
    m = _rand((17, 2, 2), 0) + 2 * np.eye(2, dtype=np.float32)
    np.testing.assert_allclose(
        np.asarray(sm.det(jnp.asarray(m))), np.linalg.det(m), rtol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(sm.inv(jnp.asarray(m))), np.linalg.inv(m), rtol=2e-4, atol=1e-5
    )


def test_det_inv_3d():
    m = _rand((23, 3, 3), 1) + 2 * np.eye(3, dtype=np.float32)
    np.testing.assert_allclose(
        np.asarray(sm.det(jnp.asarray(m))), np.linalg.det(m), rtol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(sm.inv(jnp.asarray(m))), np.linalg.inv(m), rtol=2e-3, atol=1e-4
    )


def test_trace_transpose_matmul():
    a = _rand((5, 3, 3), 2)
    b = _rand((5, 3, 3), 3)
    np.testing.assert_allclose(
        np.asarray(sm.trace(jnp.asarray(a))), np.trace(a, axis1=-2, axis2=-1),
        rtol=1e-6,
    )
    np.testing.assert_allclose(
        np.asarray(sm.mT(jnp.asarray(a))), np.swapaxes(a, -1, -2)
    )
    np.testing.assert_allclose(
        np.asarray(sm.matmul(jnp.asarray(a), jnp.asarray(b))), a @ b,
        rtol=1e-5, atol=1e-6,
    )


def test_sym_eigh_reconstruction_and_orthogonality():
    """Jacobi sym_eigh (the SVD-free route for the inelastic return map —
    elementwise, fused with its neighbours)."""
    for d in (2, 3):
        a = _rand((400, d, d), 7)
        c = a @ np.swapaxes(a, -1, -2)  # symmetric PSD
        # degenerate spectra: identity, near-identity, rank-deficient
        c[:40] = np.eye(d, dtype=np.float32)
        c[40:80] = np.eye(d, dtype=np.float32) + 1e-5 * c[40:80]
        c[80:120, ..., -1, :] = 0.0
        c[80:120, ..., :, -1] = 0.0
        w, v = sm.sym_eigh(jnp.asarray(c))
        w, v = np.asarray(w), np.asarray(v)
        scale = max(1.0, np.abs(c).max())
        rec = v @ (w[..., None] * np.swapaxes(v, -1, -2))
        assert np.abs(rec - c).max() / scale < 5e-6
        orth = np.abs(v @ np.swapaxes(v, -1, -2) - np.eye(d)).max()
        assert orth < 5e-6
        np.testing.assert_allclose(
            np.sort(w, axis=-1), np.linalg.eigvalsh(c),
            rtol=1e-4, atol=5e-6 * scale,
        )
