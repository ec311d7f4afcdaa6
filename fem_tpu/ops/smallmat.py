# coding=utf-8
"""Batched closed-form small-matrix primitives (dim ∈ {2, 3}).

The whole FEM compute path operates on dense batches of dim×dim matrices
``(E, d, d)``.  Generic ``jnp.linalg`` batched inverses lower to library
calls per batch; closed-form cofactor formulas stay fully elementwise
(fusable by XLA into the surrounding element chain), which is the idiomatic
replacement for the
reference's per-element ``ti.math.inverse`` / ``.determinant()`` calls
(reference: solver/explicit.py:23-24, solver/implicit.py:84,128).

All functions take arrays whose *last two* axes are the matrix axes and are
batched over any leading axes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def det(m: jnp.ndarray) -> jnp.ndarray:
    """Determinant of (..., d, d), d in {2, 3}, closed form."""
    d = m.shape[-1]
    if d == 2:
        return m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
    if d == 3:
        return (
            m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1])
            - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 0])
            + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0])
        )
    raise ValueError(f"unsupported matrix dim {d}")


def adjugate(m: jnp.ndarray) -> jnp.ndarray:
    """Adjugate (cofactor transpose) of (..., d, d) — always finite."""
    d = m.shape[-1]
    if d == 2:
        return jnp.stack(
            [
                jnp.stack([m[..., 1, 1], -m[..., 0, 1]], axis=-1),
                jnp.stack([-m[..., 1, 0], m[..., 0, 0]], axis=-1),
            ],
            axis=-2,
        )
    if d == 3:
        c00 = m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1]
        c01 = m[..., 1, 2] * m[..., 2, 0] - m[..., 1, 0] * m[..., 2, 2]
        c02 = m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]
        c10 = m[..., 0, 2] * m[..., 2, 1] - m[..., 0, 1] * m[..., 2, 2]
        c11 = m[..., 0, 0] * m[..., 2, 2] - m[..., 0, 2] * m[..., 2, 0]
        c12 = m[..., 0, 1] * m[..., 2, 0] - m[..., 0, 0] * m[..., 2, 1]
        c20 = m[..., 0, 1] * m[..., 1, 2] - m[..., 0, 2] * m[..., 1, 1]
        c21 = m[..., 0, 2] * m[..., 1, 0] - m[..., 0, 0] * m[..., 1, 2]
        c22 = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
        return jnp.stack(
            [
                jnp.stack([c00, c10, c20], axis=-1),
                jnp.stack([c01, c11, c21], axis=-1),
                jnp.stack([c02, c12, c22], axis=-1),
            ],
            axis=-2,
        )
    raise ValueError(f"unsupported matrix dim {d}")


def cofactor(m: jnp.ndarray) -> jnp.ndarray:
    """Cofactor matrix cof(M) = adj(M)ᵀ = ∂det(M)/∂M — polynomial in the
    entries, hence finite and smooth for ALL matrices including singular and
    inverted ones (unlike det·M⁻ᵀ).  Used by the inversion-robust
    ``stable_neo_hookean`` material."""
    return mT(adjugate(m))


def d_cofactor(m: jnp.ndarray, d: jnp.ndarray) -> jnp.ndarray:
    """Exact directional derivative D cof(M)[D] of the cofactor map.

    2D: cof is linear, so the derivative is cof(D) itself.  3D: cof is
    quadratic; each entry is a 2×2 minor, so the derivative is the product
    rule applied entrywise (bilinear in (M, D)) — explicit formula rather
    than polarization ``cof(M+D) − cof(M) − cof(D)`` to avoid cancellation
    when ``‖D‖ ≪ ‖M‖``."""
    dd = m.shape[-1]
    if dd == 2:
        return cofactor(d)
    if dd == 3:
        def minor2(a, b, i0, j0, i1, j1):
            # product-rule of a 2x2 minor a[i0,j0]*a[i1,j1] - a[i0,j1]*a[i1,j0]
            return (
                a[..., i0, j0] * b[..., i1, j1]
                + b[..., i0, j0] * a[..., i1, j1]
                - a[..., i0, j1] * b[..., i1, j0]
                - b[..., i0, j1] * a[..., i1, j0]
            )

        rows = []
        idx = [0, 1, 2]
        for i in range(3):
            p, q = [r for r in idx if r != i]
            row = []
            for j in range(3):
                r, s = [c for c in idx if c != j]
                sign = 1.0 if (i + j) % 2 == 0 else -1.0
                row.append(sign * minor2(m, d, p, r, q, s))
            rows.append(jnp.stack(row, axis=-1))
        return jnp.stack(rows, axis=-2)
    raise ValueError(f"unsupported matrix dim {dd}")


def inv(m: jnp.ndarray) -> jnp.ndarray:
    """Inverse of (..., d, d), d in {2, 3}, via adjugate / det."""
    return adjugate(m) / det(m)[..., None, None]


def safe_inv(m: jnp.ndarray, det_eps: float = 1e-6) -> jnp.ndarray:
    """Inverse with the determinant clamped away from zero (sign-preserving).

    Extension of the reference's inversion guard: the reference clamps only
    ``log(det F)`` in the implicit Hessian (solver/implicit.py:131) but still
    divides by the raw determinant in ``ti.math.inverse`` — a degenerate
    element therefore NaNs the whole solve.  ``safe_inv`` keeps the adjugate
    direction and bounds the magnitude, letting impacts recover (used only
    when ``robust_inversion`` is enabled; default path matches the reference).
    """
    dt = det(m)
    sign = jnp.where(dt < 0, -1.0, 1.0).astype(m.dtype)
    dt_safe = sign * jnp.maximum(jnp.abs(dt), det_eps)
    return adjugate(m) / dt_safe[..., None, None]


def trace(m: jnp.ndarray) -> jnp.ndarray:
    """Trace of (..., d, d)."""
    return jnp.trace(m, axis1=-2, axis2=-1)


def mT(m: jnp.ndarray) -> jnp.ndarray:
    """Transpose of the last two axes."""
    return jnp.swapaxes(m, -1, -2)


def matmul(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched (..., d, d) @ (..., d, d).

    Full-f32 precision: a float32 matmul may otherwise run in reduced
    precision (TF32 on GPUs), far too coarse for deformation gradients
    (F at rest must be I to f32 epsilon).
    """
    return jnp.einsum(
        "...ij,...jk->...ik", a, b, precision=jax.lax.Precision.HIGHEST
    )


def matmul_ew(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched (..., d, d) @ (..., d, d) as explicit componentwise
    multiply-adds: elementwise arithmetic that fuses with its neighbours;
    each output component is an exact f32 three-term sum — no precision
    flag needed."""
    d = a.shape[-1]
    rows = []
    for i in range(d):
        cols = []
        for j in range(d):
            s = a[..., i, 0] * b[..., 0, j]
            for k in range(1, d):
                s = s + a[..., i, k] * b[..., k, j]
            cols.append(s)
        rows.append(jnp.stack(cols, axis=-1))
    return jnp.stack(rows, axis=-2)


def gram(f: jnp.ndarray) -> jnp.ndarray:
    """FᵀF of (..., d, d), componentwise (see :func:`matmul_ew`)."""
    d = f.shape[-1]
    rows = []
    for i in range(d):
        cols = []
        for j in range(d):
            s = f[..., 0, i] * f[..., 0, j]
            for k in range(1, d):
                s = s + f[..., k, i] * f[..., k, j]
            cols.append(s)
        rows.append(jnp.stack(cols, axis=-1))
    return jnp.stack(rows, axis=-2)


def polar_rotation(m: jnp.ndarray, iters: int = 12) -> jnp.ndarray:
    """Rotation factor R of the polar decomposition M = R·S via Higham's
    Newton iteration ``R ← ½(R + R⁻ᵀ)`` (quadratic convergence for
    well-conditioned M; a fixed unrolled iteration keeps it jit- and
    autodiff-friendly — unlike SVD, it is smooth at repeated singular
    values, so gradients are defined at the rest pose F = I).

    Used by the ``corotated`` material extension.  For det(M) < 0 the limit
    is the orthogonal (not special-orthogonal) factor — the standard
    corotated-model failure under inversion, same class as the reference's
    unclamped Neo-Hookean log.
    """
    r = m
    for _ in range(iters):
        r = 0.5 * (r + mT(inv(r)))
    return r


def sym_eigh_core(a: dict, d: int, sweeps: int = 6):
    """Cyclic-Jacobi eigendecomposition on COMPONENT PLANES: ``a`` maps
    (i, j) with i ≤ j to the symmetric matrix's (...,)-shaped component
    arrays (any shape).  Returns the rotated-diagonal dict (eigenvalues at
    (i, i)) and the accumulated rotation dict v[(i, j)] with
    A = V·diag(w)·Vᵀ.  This is the whole algorithm of :func:`sym_eigh`."""
    pairs = [(0, 1)] if d == 2 else [(0, 1), (0, 2), (1, 2)]
    a = dict(a)
    one = jnp.ones_like(a[(0, 0)])
    zero = jnp.zeros_like(one)
    v = {(i, j): (one if i == j else zero) for i in range(d) for j in range(d)}

    def sym(i, j):
        return (i, j) if i <= j else (j, i)

    for _ in range(1 if d == 2 else sweeps):
        for p, q in pairs:
            app, aqq, apq = a[(p, p)], a[(q, q)], a[(p, q)]
            # Stable Jacobi angle: t = sgn(τ)/(|τ|+√(1+τ²)), τ=(a_qq−a_pp)/2a_pq.
            # τ = 0 with a_pq ≠ 0 is a 45° rotation (t = 1) — use a ±1 sign,
            # not sign(τ) (which is 0 at 0); a_pq = 0 → identity rotation.
            off = jnp.abs(apq) > 0.0
            tau = (aqq - app) / (2.0 * jnp.where(off, apq, one))
            sgn = jnp.where(tau >= 0.0, 1.0, -1.0)
            t = jnp.where(
                off, sgn / (jnp.abs(tau) + jnp.sqrt(1.0 + tau * tau)), 0.0
            )
            c = 1.0 / jnp.sqrt(1.0 + t * t)
            s = t * c
            # A ← GᵀAG (G rotates columns p,q by angle θ): closed component form.
            a[(p, p)] = c * c * app - 2.0 * s * c * apq + s * s * aqq
            a[(q, q)] = s * s * app + 2.0 * s * c * apq + c * c * aqq
            a[(p, q)] = zero  # annihilated by construction
            for r in range(d):
                if r == p or r == q:
                    continue
                apr, aqr = a[sym(p, r)], a[sym(q, r)]
                a[sym(p, r)] = c * apr - s * aqr
                a[sym(q, r)] = s * apr + c * aqr
            # V ← VG: rotate columns p and q.
            for i in range(d):
                vip, viq = v[(i, p)], v[(i, q)]
                v[(i, p)] = c * vip - s * viq
                v[(i, q)] = s * vip + c * viq
    return a, v


def sym_eigh(m: jnp.ndarray, sweeps: int = 6):
    """Batched eigendecomposition of SYMMETRIC (..., d, d), d ∈ {2, 3}, via
    cyclic Jacobi rotations.  Returns ``(w, V)`` with ``m ≈ V·diag(w)·Vᵀ``
    (V orthogonal to ~f32 roundoff; eigenvalues NOT sorted).

    Pure elementwise math that fuses with the surrounding element chain,
    where the batched ``jnp.linalg.svd/eigh`` would each be a separate
    library call.  The rotations are applied COMPONENTWISE on (...,)-shaped
    planes.  d = 2 is exact in one rotation; d = 3 cyclic Jacobi converges
    quadratically (6 sweeps reach f32 roundoff with margin).
    """
    d = m.shape[-1]
    if d not in (2, 3):
        raise ValueError(f"unsupported matrix dim {d}")
    a = {(i, j): m[..., i, j] for i in range(d) for j in range(i, d)}
    a, v = sym_eigh_core(a, d, sweeps)
    w = jnp.stack([a[(i, i)] for i in range(d)], axis=-1)
    vm = jnp.stack(
        [
            jnp.stack([v[(i, j)] for j in range(d)], axis=-1)
            for i in range(d)
        ],
        axis=-2,
    )
    return w, vm
