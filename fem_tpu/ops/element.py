# coding=utf-8
"""Batched Neo-Hookean element kernels (the compute core).

Every function here is a *batched* pure function over all elements at once —
the replacement for the reference's Taichi kernels that parallelize an outer
per-element loop with atomic scatter-adds; XLA fuses each chain into a few
kernels:

  * deformation gradient + analytic Piola gradient: solver/explicit.py:8-49
  * elastic energy density (autodiff path):          solver/explicit_auto_diff.py:8-31
  * implicit RHS elastic force:                      solver/implicit.py:72-107
  * implicit Hessian block:                          solver/implicit.py:114-181

A key structural fact of the reference's implicit assembly (exploited here for
the matrix-free solver): in ``compute_linear_system_matrix_a`` the per-pair
block uses ``dF = (i==j ? I : 0) @ R_inv`` (solver/implicit.py:141-144), so all
``i != j`` blocks are exactly zero and the ``i == j`` block is the *same*
matrix for every local vertex.  Each element therefore contributes one d×d
block ``K_e`` scattered in a graph-Laplacian pattern:

    A[v_i, v_i] += K_e            (i = 1..d)
    A[v_i, v_0] -= K_e,  A[v_0, v_i] -= K_e
    A[v_0, v_0] += d * K_e

which admits an O(E) matrix-free product (see solvers/implicit.py) instead of
the reference's dense O(N^2) storage and O(N^2)-per-iteration products.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from fem_tpu.ops import smallmat as sm
from fem_tpu.ops.assembly import gather_edge_diffs


def mooney_params(
    mu: float, s_lambda: float, d: int, material: str
) -> tuple:
    """Parse a ``mooney_rivlin[:beta]`` material string into the three
    energy coefficients ``(c1, c2, lam_log)`` (framework extension — the
    reference has no Mooney–Rivlin; spelled like the repo's other
    parameterized static strings, e.g. ``two_level_cheb<k>``).

    Compressible Mooney–Rivlin, rest-stable and small-strain-consistent in
    both 2D and 3D:

        φ = C1·(I₁ − d) + C2·(I₂ − d(d−1)/2)
            − (2C1 + 2(d−1)C2)·logJ + λ_log/2·logJ²

    with I₁ = tr(C), I₂ = ½(tr(C)² − tr(C²)), C = FᵀF.  ``beta`` ∈ [0, 1)
    is the fraction of the shear modulus carried by the I₂ term (default
    0.5; ``beta = 0`` reduces the model EXACTLY to the reference's
    Neo-Hookean).  Calibration so the linearization at F = I equals linear
    elasticity with the object's (μ, λ) in every dimension:

        C2 = β·μ/2,   C1 = μ/2 − (d−2)·C2,   λ_log = λ − 4·C2

    (derived: DP(I)[D] = (2C1 + 2(d−2)C2)(D + Dᵀ) + (λ_log + 4C2)tr(D)I).
    Raises at trace time when λ − 4C2 < 0 (the volumetric log term would
    turn concave) — lower ``beta`` or raise the Poisson ratio.
    """
    base, _, arg = material.partition(":")
    assert base == "mooney_rivlin"
    beta = float(arg) if arg else 0.5
    if not 0.0 <= beta < 1.0:
        raise ValueError(f"mooney_rivlin beta must be in [0, 1): {material!r}")
    c2 = beta * mu / 2.0
    c1 = mu / 2.0 - (d - 2) * c2
    lam_log = s_lambda - 4.0 * c2
    if lam_log < 0.0 or c1 <= 0.0:
        raise ValueError(
            f"mooney_rivlin calibration infeasible for {material!r}: "
            f"needs lambda >= 4*C2 (= 2*beta*mu) and C1 > 0; got "
            f"mu={mu}, lambda={s_lambda}, d={d} -> C1={c1}, "
            f"lam_log={lam_log}. Lower beta or raise poisson_ratio."
        )
    return c1, c2, lam_log


def _is_mooney(material: str) -> bool:
    return material.partition(":")[0] == "mooney_rivlin"


def fiber_params(mu: float, d: int, material: str) -> tuple:
    """Parse a ``fiber:a1,a2[,a3][:kappa]`` material string into the unit
    fiber direction ``a`` (tuple of ``d`` floats) and the fiber stiffness
    ``k = kappa·mu`` (framework extension — transversely isotropic
    fiber-reinforced solid; the reference has isotropic materials only).

    The model is the ``stable_neo_hookean`` isotropic base plus the
    standard-reinforcing anisotropic term

        φ_f = k/2 · (I₄ − 1)²,   I₄ = aᵀFᵀFa = |Fa|²

    (the polynomial core of fiber-reinforced models à la
    Holzapfel–Gasser–Ogden with the exponential removed): rest-stable
    (I₄(I) = 1 ⇒ P_f(I) = 0), objective (I₄ is invariant under rotations
    F → QF), polynomial in F — finite through inversion like its base —
    and stiffening the response along ``a`` while leaving the transverse
    plane isotropic.  ``kappa`` (default 1.0) is the fiber modulus in
    units of the object's shear modulus μ.
    """
    base, _, rest = material.partition(":")
    assert base == "fiber"
    dir_str, _, kap_str = rest.partition(":")
    comps = tuple(float(x) for x in dir_str.split(",") if x != "")
    if len(comps) != d:
        raise ValueError(
            f"fiber direction has {len(comps)} components for dim={d}: "
            f"{material!r}"
        )
    norm = sum(x * x for x in comps) ** 0.5
    if norm == 0.0:
        raise ValueError(f"fiber direction must be nonzero: {material!r}")
    kappa = float(kap_str) if kap_str else 1.0
    if kappa <= 0.0:
        raise ValueError(f"fiber kappa must be > 0: {material!r}")
    return tuple(x / norm for x in comps), kappa * mu


def _is_fiber(material: str) -> bool:
    return material.partition(":")[0] == "fiber"


def deformation_gradients(
    pos: jnp.ndarray, element_indices: jnp.ndarray, ref_inv: jnp.ndarray
) -> jnp.ndarray:
    """F = X @ R_inv for all elements: ``(E, d, d)``.

    Reference: solver/explicit.py:12-19 (same construction in all four
    reference kernels).
    """
    x_mat = gather_edge_diffs(pos, element_indices)
    return sm.matmul(x_mat, ref_inv)


def energy_density(
    F: jnp.ndarray, mu: float, s_lambda: float, material: str = "neo_hookean"
) -> jnp.ndarray:
    """Elastic energy density φ(F).

    * ``neo_hookean`` (reference live path, solver/explicit_auto_diff.py:24-28):
      φ = μ/2 (tr(FᵀF) − d) − μ logJ + λ/2 logJ², with ``logJ = log(det F)``
      deliberately *unclamped* — an inverted element yields NaN exactly as the
      reference does.
    * ``stvk`` (the reference's latent St. Venant–Kirchhoff variant, present
      but commented out at solver/explicit_auto_diff.py:32-38):
      G = ½(FᵀF − I), φ = μ·Σ G² + λ/2·tr(G)².
    * ``linear`` (framework extension — small-strain linear elasticity):
      ε = ½(F + Fᵀ) − I, φ = μ·Σ ε² + λ/2·tr(ε)².
    * ``corotated`` (framework extension — the standard graphics co-rotated
      model): φ = μ·‖F − R‖² + λ/2·tr(RᵀF − I)² with R = polar(F)
      (tie-robust Higham iteration, smallmat.polar_rotation — smooth at the
      rest pose where SVD-based formulations have undefined gradients).
    * ``stable_neo_hookean`` (framework extension — the polynomial core of
      Smith, de Goes & Kim, "Stable Neo-Hookean Flesh Simulation", TOG 2018):
      φ = μ/2 (I_C − d) − μ(J − 1) + λ'/2 (J − 1)² with λ' = λ + μ (the
      paper's reparameterization, which makes DP(I) match linear elasticity
      exactly).  Polynomial in F — finite and smooth for ALL F *including
      inversion* (no log barrier), rest-stable (P(I) = 0), with a strong
      volume-recovery term: the inversion-robust production alternative to
      the reference's NH (which NaNs) and StVK (which has no volume barrier
      at all and collapses).
    """
    d = F.shape[-1]
    if material == "stable_neo_hookean":
        lam_p = s_lambda + mu
        j = sm.det(F)
        i_c = jnp.einsum(
            "...ij,...ij->...", F, F, precision=jax.lax.Precision.HIGHEST
        )
        return (
            mu / 2.0 * (i_c - d) - mu * (j - 1.0)
            + lam_p / 2.0 * (j - 1.0) * (j - 1.0)
        )
    if material == "corotated":
        r = sm.polar_rotation(F)
        diff = F - r
        s_tr = sm.trace(sm.matmul(sm.mT(r), F)) - d
        return (
            mu * jnp.einsum(
                "...ij,...ij->...", diff, diff,
                precision=jax.lax.Precision.HIGHEST,
            )
            + s_lambda / 2.0 * s_tr * s_tr
        )
    if material == "linear":
        eps = 0.5 * (F + sm.mT(F)) - jnp.broadcast_to(
            jnp.eye(d, dtype=F.dtype), F.shape
        )
        eps_sq = jnp.einsum(
            "...ij,...ij->...", eps, eps, precision=jax.lax.Precision.HIGHEST
        )
        tr_e = sm.trace(eps)
        return mu * eps_sq + s_lambda / 2.0 * tr_e * tr_e
    if material == "stvk":
        c = jnp.einsum(
            "...ki,...kj->...ij", F, F, precision=jax.lax.Precision.HIGHEST
        )
        g = 0.5 * (c - jnp.broadcast_to(jnp.eye(d, dtype=F.dtype), c.shape))
        g_sq = jnp.einsum(
            "...ij,...ij->...", g, g, precision=jax.lax.Precision.HIGHEST
        )
        tr_g = sm.trace(g)
        return mu * g_sq + s_lambda / 2.0 * tr_g * tr_g
    if _is_fiber(material):
        # Transversely isotropic fiber reinforcement (see fiber_params):
        # stable-NH base + k/2·(I₄ − 1)² along the unit fiber direction.
        a, k = fiber_params(mu, d, material)
        a_vec = jnp.asarray(a, F.dtype)
        fa = jnp.einsum(
            "...ij,j->...i", F, a_vec, precision=jax.lax.Precision.HIGHEST
        )
        i4 = jnp.sum(fa * fa, axis=-1)
        base = energy_density(F, mu, s_lambda, "stable_neo_hookean")
        return base + 0.5 * k * (i4 - 1.0) * (i4 - 1.0)
    if _is_mooney(material):
        # Compressible Mooney–Rivlin (see mooney_params for the form and
        # calibration; beta=0 is exactly the reference's Neo-Hookean).
        c1, c2, lam_log = mooney_params(mu, s_lambda, d, material)
        c = jnp.einsum(
            "...ki,...kj->...ij", F, F, precision=jax.lax.Precision.HIGHEST
        )
        i1 = sm.trace(c)
        i2 = 0.5 * (i1 * i1 - jnp.einsum(
            "...ij,...ij->...", c, c, precision=jax.lax.Precision.HIGHEST
        ))
        log_j = jnp.log(sm.det(F))  # unclamped, as the reference's NH
        return (
            c1 * (i1 - d)
            + c2 * (i2 - d * (d - 1) / 2.0)
            - (2.0 * c1 + 2.0 * (d - 1) * c2) * log_j
            + lam_log / 2.0 * log_j * log_j
        )
    if material != "neo_hookean":
        raise ValueError(f"unknown material {material!r}")
    log_j = jnp.log(sm.det(F))
    i_c = jnp.einsum(
        "...ij,...ij->...", F, F, precision=jax.lax.Precision.HIGHEST
    )  # tr(FᵀF)
    return (
        mu / 2.0 * (i_c - d) - mu * log_j + s_lambda / 2.0 * log_j * log_j
    )


def total_energy(
    pos: jnp.ndarray,
    element_indices: jnp.ndarray,
    ref_inv: jnp.ndarray,
    volume: jnp.ndarray,
    mu: float,
    s_lambda: float,
    material: str = "neo_hookean",
) -> jnp.ndarray:
    """U = Σ_e V_e φ(F_e) — the autodiff loss (reference: U accumulation at
    solver/explicit_auto_diff.py:30; tape at main.py:107)."""
    F = deformation_gradients(pos, element_indices, ref_inv)
    return jnp.sum(volume * energy_density(F, mu, s_lambda, material))


def element_energies(
    pos: jnp.ndarray,
    element_indices: jnp.ndarray,
    ref_inv: jnp.ndarray,
    volume: jnp.ndarray,
    mu: float,
    s_lambda: float,
    material: str = "neo_hookean",
) -> jnp.ndarray:
    """Per-element V·φ used for render coloring (reference: ``obj.phi`` write
    at solver/explicit_auto_diff.py:29).  Sized ``(E,)`` — fixing the
    reference's out-of-bounds sizing by surface-face count (object.py:68)."""
    F = deformation_gradients(pos, element_indices, ref_inv)
    return volume * energy_density(F, mu, s_lambda, material)


def first_piola(
    F: jnp.ndarray, mu: float, s_lambda: float, material: str = "neo_hookean"
) -> jnp.ndarray:
    """Analytic first Piola–Kirchhoff stress P(F) = ∂φ/∂F per material
    (matches :func:`energy_density` exactly — parity pinned by the
    autodiff-vs-analytic tests):

    * ``neo_hookean``: μF − μF⁻ᵀ + λ·log(det F)·F⁻ᵀ (reference
      solver/explicit.py:23-28, unclamped log).
    * ``stvk``: F·(2μG + λ·tr(G)·I) with G = ½(FᵀF − I).
    * ``linear``: 2με + λ·tr(ε)·I with ε = ½(F + Fᵀ) − I.
    * ``corotated``: 2μ(F − R) + λ·tr(RᵀF − I)·R, R = polar(F) — exact
      (the δR terms vanish: R is the nearest rotation, and ∂tr(RᵀF)/∂F = R).
    * ``stable_neo_hookean``: μF + (λ'(J−1) − μ)·cof(F) with λ' = λ + μ and
      cof(F) = ∂J/∂F the (polynomial) cofactor matrix — finite for all F.
    """
    d = F.shape[-1]
    eye = jnp.broadcast_to(jnp.eye(d, dtype=F.dtype), F.shape)
    if material == "stable_neo_hookean":
        lam_p = s_lambda + mu
        g = sm.cofactor(F)
        s = (lam_p * (sm.det(F) - 1.0) - mu)[..., None, None]
        return mu * F + s * g
    if material == "corotated":
        r = sm.polar_rotation(F)
        s_tr = (sm.trace(sm.matmul(sm.mT(r), F)) - d)[..., None, None]
        return 2.0 * mu * (F - r) + s_lambda * s_tr * r
    if material == "linear":
        eps = 0.5 * (F + sm.mT(F)) - eye
        return 2.0 * mu * eps + s_lambda * sm.trace(eps)[..., None, None] * eye
    if material == "stvk":
        c = jnp.einsum(
            "...ki,...kj->...ij", F, F, precision=jax.lax.Precision.HIGHEST
        )
        g = 0.5 * (c - eye)
        s = 2.0 * mu * g + s_lambda * sm.trace(g)[..., None, None] * eye
        return sm.matmul(F, s)
    if _is_fiber(material):
        # P = P_base + 2k·(I₄ − 1)·(Fa)aᵀ — exact ∂φ/∂F of the fiber energy
        # (∂I₄/∂F = 2·F a aᵀ); polynomial, finite for all F like its base.
        a, k = fiber_params(mu, d, material)
        a_vec = jnp.asarray(a, F.dtype)
        fa = jnp.einsum(
            "...ij,j->...i", F, a_vec, precision=jax.lax.Precision.HIGHEST
        )
        i4 = jnp.sum(fa * fa, axis=-1)[..., None, None]
        outer = jnp.einsum(
            "...i,j->...ij", fa, a_vec, precision=jax.lax.Precision.HIGHEST
        )
        base = first_piola(F, mu, s_lambda, "stable_neo_hookean")
        return base + 2.0 * k * (i4 - 1.0) * outer
    if _is_mooney(material):
        # P = 2C1·F + 2C2·(I₁F − FC) + (λ_log·logJ − 2C1 − 2(d−1)C2)·F⁻ᵀ —
        # exact ∂φ/∂F of the energy above; P(I) = 0 by calibration.
        c1, c2, lam_log = mooney_params(mu, s_lambda, d, material)
        c = jnp.einsum(
            "...ki,...kj->...ij", F, F, precision=jax.lax.Precision.HIGHEST
        )
        i1 = sm.trace(c)[..., None, None]
        f_inv_t = sm.mT(sm.inv(F))
        log_j = jnp.log(sm.det(F))[..., None, None]
        return (
            2.0 * c1 * F
            + 2.0 * c2 * (i1 * F - sm.matmul(F, c))
            + (lam_log * log_j - 2.0 * c1 - 2.0 * (d - 1) * c2) * f_inv_t
        )
    if material != "neo_hookean":
        raise ValueError(f"unknown material {material!r}")
    f_inv_t = sm.mT(sm.inv(F))
    log_j = jnp.log(sm.det(F))[..., None, None]
    return mu * F - mu * f_inv_t + s_lambda * log_j * f_inv_t


def explicit_grad_columns(
    pos: jnp.ndarray,
    element_indices: jnp.ndarray,
    ref_inv: jnp.ndarray,
    volume: jnp.ndarray,
    mu: float,
    s_lambda: float,
    material: str = "neo_hookean",
) -> jnp.ndarray:
    """Analytic energy-gradient columns for the explicit path: ``(E, d, d)``.

    ``H = V · P(F) @ R_invᵀ`` with column j going to local vertex j+1 and
    −Σ columns to vertex 0 (reference: solver/explicit.py:23-49).  Note the
    reference *accumulates the gradient of the energy* into
    ``particles.force`` (it is subtracted in kinematic:
    solver/kinematic.py:19), so these are +∂U/∂x contributions.
    """
    F = deformation_gradients(pos, element_indices, ref_inv)
    P = first_piola(F, mu, s_lambda, material)
    return volume[..., None, None] * sm.matmul(P, sm.mT(ref_inv))


def implicit_force_columns(
    pos: jnp.ndarray,
    element_indices: jnp.ndarray,
    ref_inv: jnp.ndarray,
    volume: jnp.ndarray,
    mu: float,
    s_lambda: float,
    robust: bool = False,
) -> jnp.ndarray:
    """Elastic force columns for the implicit RHS b: ``(E, d, d)``.

    Reference (solver/implicit.py:87-88) uses ``λ/2·log(det(FᵀF))`` — equal to
    ``λ·log|det F|``, i.e. finite even for inverted elements, unlike the
    explicit path — and multiplies by ``−V`` (force, not gradient).
    """
    F = deformation_gradients(pos, element_indices, ref_inv)
    if robust:
        # robust_inversion extension: clamp the determinant in F-inverse and
        # the log argument so degenerate elements stay finite (the reference
        # applies this guard only to logJ in the Hessian, implicit.py:131).
        f_inv_t = sm.mT(sm.safe_inv(F))
        gram_det = jnp.maximum(sm.det(sm.matmul(sm.mT(F), F)), 1e-8)
    else:
        f_inv_t = sm.mT(sm.inv(F))
        gram_det = sm.det(sm.matmul(sm.mT(F), F))
    log_term = jnp.log(gram_det)[..., None, None]
    P = mu * F - mu * f_inv_t + (s_lambda / 2.0) * log_term * f_inv_t
    return -volume[..., None, None] * sm.matmul(P, sm.mT(ref_inv))


def cauchy_stress(
    F: jnp.ndarray, mu: float, s_lambda: float, material: str = "neo_hookean"
) -> jnp.ndarray:
    """True (Cauchy) stress σ = P(F)·Fᵀ / det(F) per element: ``(…, d, d)``.

    Post-processing extension — the reference renders only the energy
    density (``obj.phi``) and exposes no stress field.  For every isotropic
    hyperelastic material here σ is symmetric (balance of angular momentum)
    and objective (σ(RF) = R σ Rᵀ); the small-strain ``linear`` model is
    not objective — by construction — and its σ is reported the same way.
    """
    P = first_piola(F, mu, s_lambda, material)
    J = sm.det(F)[..., None, None]
    return sm.matmul(P, sm.mT(F)) / J


def von_mises(sigma: jnp.ndarray) -> jnp.ndarray:
    """Von Mises equivalent stress √(3/2 · s:s) of the deviatoric part
    s = σ − tr(σ)/d·I: the standard scalar yield/visualization measure.
    For a uniaxial σ = diag(s, 0, 0) in 3D this is exactly |s|."""
    d = sigma.shape[-1]
    tr = sm.trace(sigma)[..., None, None] / d
    dev = sigma - tr * jnp.broadcast_to(
        jnp.eye(d, dtype=sigma.dtype), sigma.shape
    )
    return jnp.sqrt(
        1.5 * jnp.einsum(
            "...ij,...ij->...", dev, dev, precision=jax.lax.Precision.HIGHEST
        )
    )


def element_stresses(
    pos: jnp.ndarray,
    element_indices: jnp.ndarray,
    ref_inv: jnp.ndarray,
    mu: float,
    s_lambda: float,
    material: str = "neo_hookean",
) -> jnp.ndarray:
    """Per-element Cauchy stress tensors at the current positions: (E, d, d)."""
    F = deformation_gradients(pos, element_indices, ref_inv)
    return cauchy_stress(F, mu, s_lambda, material)


def first_piola_dp(
    F: jnp.ndarray,
    D: jnp.ndarray,
    mu: float,
    s_lambda: float,
    material: str = "neo_hookean",
    robust: bool = False,
) -> jnp.ndarray:
    """Directional derivative ``DP(F)[D]`` of the first Piola stress, per
    material — the generalization of the reference's decoupled-Hessian
    integrand (solver/implicit.py:131-147, which is exactly the Neo-Hookean
    instance of this formula with ``D = R_inv``):

    * ``neo_hookean``: μD + (μ − λ·logJ)·F⁻ᵀDᵀF⁻ᵀ + λ·tr(F⁻¹D)·F⁻ᵀ with
      ``logJ = log(max(det F, 1e-4))`` (the reference's inversion clamp).
    * ``stvk``: D·S + F·(μ(DᵀF + FᵀD) + λ·tr(FᵀD)·I), S = 2μG + λ·tr(G)·I —
      the exact derivative of :func:`first_piola`.
    * ``linear``: μ(D + Dᵀ) + λ·tr(D)·I — exact (P is affine in F).
    * ``corotated``: 2μD + λ·tr(RᵀD)·R with R = polar(F) held FIXED — the
      standard fixed-rotation linearization (δR terms dropped), matching the
      decoupled spirit of the reference's integrator; equals the jvp of P
      with R stop-gradiented (pinned by tests/test_materials.py).
    * ``stable_neo_hookean``: μD + λ'(cof(F):D)·cof(F)
      + (λ'(J−1) − μ)·Dcof(F)[D] — the exact derivative of
      :func:`first_piola` (cof and its derivative are polynomial: finite
      everywhere, no clamp needed).
    """
    d = F.shape[-1]
    eye = jnp.broadcast_to(jnp.eye(d, dtype=F.dtype), F.shape)
    if material == "stable_neo_hookean":
        lam_p = s_lambda + mu
        g = sm.cofactor(F)
        dj = jnp.einsum(
            "...ij,...ij->...", g, D, precision=jax.lax.Precision.HIGHEST
        )[..., None, None]
        s = (lam_p * (sm.det(F) - 1.0) - mu)[..., None, None]
        return mu * D + lam_p * dj * g + s * sm.d_cofactor(F, D)
    if material == "corotated":
        r = sm.polar_rotation(F)
        tr_rd = sm.trace(sm.matmul(sm.mT(r), D))[..., None, None]
        return 2.0 * mu * D + s_lambda * tr_rd * r
    if material == "linear":
        sym = D + sm.mT(D)
        return mu * sym + s_lambda * sm.trace(D)[..., None, None] * eye
    if material == "stvk":
        c = sm.matmul(sm.mT(F), F)
        g = 0.5 * (c - eye)
        s = 2.0 * mu * g + s_lambda * sm.trace(g)[..., None, None] * eye
        dtf = sm.matmul(sm.mT(D), F)
        sym = dtf + sm.mT(dtf)  # DᵀF + FᵀD
        ds = mu * sym + s_lambda * sm.trace(dtf)[..., None, None] * eye
        return sm.matmul(D, s) + sm.matmul(F, ds)
    if _is_fiber(material):
        # Exact derivative of the fiber P: with w = Fa, δw = Da,
        #   DP_f[D] = 2k·[ 2(w·δw)·w aᵀ + (I₄ − 1)·δw aᵀ ]  — polynomial.
        a, k = fiber_params(mu, d, material)
        a_vec = jnp.asarray(a, F.dtype)
        fa = jnp.einsum(
            "...ij,j->...i", F, a_vec, precision=jax.lax.Precision.HIGHEST
        )
        da = jnp.einsum(
            "...ij,j->...i", D, a_vec, precision=jax.lax.Precision.HIGHEST
        )
        i4 = jnp.sum(fa * fa, axis=-1)[..., None, None]
        w_dot = jnp.sum(fa * da, axis=-1)[..., None, None]
        base = first_piola_dp(F, D, mu, s_lambda, "stable_neo_hookean", robust)
        return base + 2.0 * k * (
            2.0 * w_dot * jnp.einsum(
                "...i,j->...ij", fa, a_vec, precision=jax.lax.Precision.HIGHEST
            )
            + (i4 - 1.0) * jnp.einsum(
                "...i,j->...ij", da, a_vec, precision=jax.lax.Precision.HIGHEST
            )
        )
    if _is_mooney(material):
        # Exact derivative of the Mooney–Rivlin P above, with the same
        # determinant clamp / robust-inverse conventions as the NH branch
        # (clamp inactive for det F > 1e-4, so DP is the exact jvp there):
        #   DP[D] = 2C1·D + 2C2·[2(F:D)F + I₁D − DC − F(DᵀF + FᵀD)]
        #           + (2C1 + 2(d−1)C2 − λ_log·logJ)·F⁻ᵀDᵀF⁻ᵀ
        #           + λ_log·tr(F⁻¹D)·F⁻ᵀ
        c1, c2, lam_log = mooney_params(mu, s_lambda, d, material)
        c = jnp.einsum(
            "...ki,...kj->...ij", F, F, precision=jax.lax.Precision.HIGHEST
        )
        i1 = sm.trace(c)[..., None, None]
        fd = jnp.einsum(
            "...ij,...ij->...", F, D, precision=jax.lax.Precision.HIGHEST
        )[..., None, None]
        dtf = sm.matmul(sm.mT(D), F)
        dc = dtf + sm.mT(dtf)  # DᵀF + FᵀD
        f_inv = sm.safe_inv(F) if robust else sm.inv(F)
        f_inv_t = sm.mT(f_inv)
        log_j = jnp.log(jnp.maximum(sm.det(F), 1e-4))[..., None, None]
        coef = 2.0 * c1 + 2.0 * (d - 1) * c2 - lam_log * log_j
        return (
            2.0 * c1 * D
            + 2.0 * c2 * (
                2.0 * fd * F + i1 * D - sm.matmul(D, c) - sm.matmul(F, dc)
            )
            + coef * sm.matmul(sm.matmul(f_inv_t, sm.mT(D)), f_inv_t)
            + lam_log
            * sm.trace(sm.matmul(f_inv, D))[..., None, None]
            * f_inv_t
        )
    if material != "neo_hookean":
        raise ValueError(f"unknown material {material!r}")
    f_inv = sm.safe_inv(F) if robust else sm.inv(F)
    f_inv_t = sm.mT(f_inv)
    log_j = jnp.log(jnp.maximum(sm.det(F), 1e-4))[..., None, None]
    term1 = mu * D
    term2 = (mu - s_lambda * log_j) * sm.matmul(
        sm.matmul(f_inv_t, sm.mT(D)), f_inv_t
    )
    term3 = s_lambda * sm.trace(sm.matmul(f_inv, D))[..., None, None] * f_inv_t
    return term1 + term2 + term3


def hessian_blocks(
    pos: jnp.ndarray,
    element_indices: jnp.ndarray,
    ref_inv: jnp.ndarray,
    volume: jnp.ndarray,
    mu: float,
    s_lambda: float,
    robust: bool = False,
    material: str = "neo_hookean",
) -> jnp.ndarray:
    """The single per-element implicit system block ``K_e``: ``(E, d, d)``.

    For ``neo_hookean``, exactly the reference's ``dF_dxij`` for ``i == j``
    (solver/implicit.py:131-147): with ``dF = R_inv``,

        K = −V · (μ·dF + (μ − λ·logJ)·F⁻ᵀ dFᵀ F⁻ᵀ + λ·tr(F⁻¹dF)·F⁻ᵀ) @ R_invᵀ

    where ``logJ = log(max(det F, 1e-4))`` (the reference's inversion clamp,
    solver/implicit.py:131).  For the material extensions the same decoupled
    structure with the material's ``DP(F)[R_inv]`` (:func:`first_piola_dp`),
    so every solver/operator built on the one-block-per-element pattern
    (graph / mxu operators, Jacobi rows, diagonal blocks) works for
    all materials unchanged.
    """
    F = deformation_gradients(pos, element_indices, ref_inv)
    K = first_piola_dp(F, ref_inv, mu, s_lambda, material, robust)
    return -volume[..., None, None] * sm.matmul(K, sm.mT(ref_inv))
