# coding=utf-8
"""Response-spectrum analysis (seismic base excitation).

Framework extension (the reference at /root/reference is a time-domain
dynamics simulator only — main.py:102-113 integrates substeps; it has no
spectral analysis): the classic earthquake-engineering pipeline built on
the modal basis + participation factors from solvers/{modal,harmonic}.py —

  * :func:`response_spectrum` — the displacement response spectrum
    Sd(ω, ζ) of a ground-acceleration history ü_g(t): for every requested
    oscillator frequency the SDOF relative-displacement equation

        q̈ + 2ζω q̇ + ω² q = −ü_g(t)

    is rolled with the EXACT 2×2 one-step propagator (the augmented-matrix
    expm of solvers/harmonic.modal_transient — exact for the
    piecewise-constant sample-and-hold forcing), tracking the running
    |q| maximum.  One ``lax.scan`` over samples, vmapped over oscillator
    frequencies — O(nω · nt) scalar work, unconditionally stable at any
    sample dt.  Pseudo-velocity/-acceleration follow as Sv = ω·Sd,
    Sa = ω²·Sd.

  * :func:`response_spectrum_analysis` — peak modal responses under a
    rigid base excitation along ``direction``: mode i peaks at
    R_i = Γ_i · Sd(ω_i, ζ_i) · φ_i (Γ from harmonic.participation_factors),
    combined per-DOF by

      - ``"srss"``  — √(Σ R_i²), exact for well-separated modal
        frequencies (peaks statistically independent);
      - ``"cqc"``   — √(Σᵢⱼ ρᵢⱼ R_i R_j) with the Der Kiureghian
        correlation ρᵢⱼ (closely-spaced modes; ρ → I as ζ → 0 or as the
        frequencies separate, so CQC degrades gracefully to SRSS);
      - ``"abssum"``— Σ |R_i|, the rigorous upper bound (modal peaks
        assumed coincident and aligned).

    The ordering  true peak ≤ abssum  and  srss ≤ abssum  holds by
    construction; tests/test_spectrum.py pins both plus a full
    cross-validation of the combinations against the TRUE time-history
    peak (modal_transient of the same ground motion on the full basis).

Sign/units convention: ``accel`` is the ground acceleration ü_g(t)
sampled at ``dt``; the returned Sd is the peak RELATIVE displacement of
the oscillator, which is exactly what multiplies Γ_i·φ_i in the modal
combination.  ω = 0 rigid modes have no finite Sd (relative displacement
grows without bound) — they are rejected loudly; pin the structure or
drop rigid modes before a spectrum analysis, as every seismic code
assumes.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from fem_tpu.solvers.harmonic import participation_factors
from fem_tpu.solvers.modal import ModalResult

# Full-f32 products: a float32 matmul may otherwise run in TF32 on GPUs.
_mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)


class SpectrumResult(NamedTuple):
    """Response spectrum of one ground-motion record.

    ``omegas``: (nw,) oscillator circular frequencies; ``zeta``: (nw,)
    damping ratios; ``sd``: (nw,) peak relative displacement;
    ``sv``/``sa``: pseudo-velocity ω·Sd / pseudo-acceleration ω²·Sd."""

    omegas: jnp.ndarray
    zeta: jnp.ndarray
    sd: jnp.ndarray
    sv: jnp.ndarray
    sa: jnp.ndarray


def _sdof_propagator(omega, zeta, dt):
    """Exact one-step map for q̈ + 2ζωq̇ + ω²q = p (p constant over the
    step): augmented 3×3 expm packs E = e^{A·dt} and the forced column
    S = ∫₀^dt e^{Aτ}B dτ (finite even for ω = 0, singular A — same
    identity as harmonic.modal_transient)."""
    c = 2.0 * zeta * omega
    aug = jnp.array(
        [
            [0.0, 1.0, 0.0],
            [-(omega * omega), -c, 1.0],
            [0.0, 0.0, 0.0],
        ],
        jnp.float32,
    )
    m = jax.scipy.linalg.expm(aug * dt)
    return m[:2, :2], m[:2, 2]


def response_spectrum(
    accel: jnp.ndarray,
    dt: float,
    omegas: jnp.ndarray,
    zeta: float | jnp.ndarray = 0.05,
) -> SpectrumResult:
    """Displacement/pseudo-velocity/pseudo-acceleration response spectrum
    of the ground-acceleration record ``accel`` (nt,) sampled at ``dt``.

    ``omegas``: (nw,) oscillator circular frequencies (rad/s), all > 0;
    ``zeta``: scalar or (nw,) damping ratios.  The oscillator starts at
    rest; the record is followed by NOTHING (peaks after the record's end
    beyond one free-vibration half-cycle are not captured — standard
    practice appends a quiet tail to the record when that matters, and
    for ζ > 0 the in-record peak dominates anyway)."""
    accel = jnp.asarray(accel, jnp.float32)
    omegas = jnp.atleast_1d(jnp.asarray(omegas, jnp.float32))
    zeta_v = jnp.broadcast_to(
        jnp.asarray(zeta, jnp.float32), omegas.shape
    )
    if accel.ndim != 1:
        raise ValueError(f"accel must be (nt,), got {accel.shape}")

    def one_freq(w, z):
        e_mat, s_vec = _sdof_propagator(w, z, float(dt))

        def step(carry, a):
            y, peak = carry
            y_new = _mm(e_mat, y) + s_vec * (-a)
            return (y_new, jnp.maximum(peak, jnp.abs(y_new[0]))), None

        (y, peak), _ = jax.lax.scan(
            step, (jnp.zeros((2,), jnp.float32), jnp.float32(0.0)), accel
        )
        return peak

    sd = jax.vmap(one_freq)(omegas, zeta_v)
    return SpectrumResult(
        omegas=omegas, zeta=zeta_v, sd=sd,
        sv=omegas * sd, sa=omegas * omegas * sd,
    )


def cqc_correlation(
    omegas: jnp.ndarray, zeta: jnp.ndarray
) -> jnp.ndarray:
    """Der Kiureghian CQC modal-correlation matrix ρᵢⱼ for frequencies
    ωᵢ and damping ratios ζᵢ:

        r = ωⱼ/ωᵢ,
        ρᵢⱼ = 8√(ζᵢζⱼ)(ζᵢ + r·ζⱼ)·r^{3/2}
              / ((1−r²)² + 4ζᵢζⱼ·r·(1+r²) + 4(ζᵢ²+ζⱼ²)·r²).

    ρᵢᵢ = 1 exactly; ρ → identity as the frequencies separate or ζ → 0
    (where CQC reduces to SRSS)."""
    w = jnp.asarray(omegas, jnp.float32)
    z = jnp.broadcast_to(jnp.asarray(zeta, jnp.float32), w.shape)
    r = w[None, :] / jnp.maximum(w[:, None], 1e-30)
    zi, zj = z[:, None], z[None, :]
    num = 8.0 * jnp.sqrt(zi * zj) * (zi + r * zj) * r ** 1.5
    den = (
        (1.0 - r * r) ** 2
        + 4.0 * zi * zj * r * (1.0 + r * r)
        + 4.0 * (zi * zi + zj * zj) * r * r
    )
    rho = num / jnp.maximum(den, 1e-30)
    # ζ = 0 rows/columns: the formula gives 0/0 → 0 off-diagonal, which is
    # the correct undamped limit; force the exact unit diagonal.
    k = w.shape[0]
    return rho.at[jnp.arange(k), jnp.arange(k)].set(1.0)


class RSResult(NamedTuple):
    """Response-spectrum combination output.

    ``peak``: (N, d) combined per-DOF peak displacement (non-negative);
    ``modal_peaks``: (k, N, d) signed per-mode peak fields
    R_i = Γᵢ·Sd(ωᵢ)·φᵢ; ``sd``: (k,) spectral displacements used;
    ``factors``: (k,) participation factors Γᵢ; ``rho``: (k, k) CQC
    correlation (identity for srss/abssum); ``captured``: Σ Γᵢ²/M_total
    modal-mass adequacy (codes demand ≳0.9)."""

    peak: jnp.ndarray
    modal_peaks: jnp.ndarray
    sd: jnp.ndarray
    factors: jnp.ndarray
    rho: jnp.ndarray
    captured: jnp.ndarray


def response_spectrum_analysis(
    modal: ModalResult,
    mass: jnp.ndarray,
    direction,
    spectrum: SpectrumResult | None = None,
    sd: Optional[jnp.ndarray] = None,
    zeta: float | jnp.ndarray = 0.05,
    combination: str = "cqc",
    omega_floor: float = 1e-4,
) -> RSResult:
    """Peak response of the structure to a rigid base excitation along
    ``direction``, combined from per-mode spectral peaks.

    ``spectrum``: a :class:`SpectrumResult` evaluated AT the modal
    frequencies (build one with ``response_spectrum(accel, dt,
    omegas=jnp.sqrt(modal.omega_sq), zeta=zeta)``), or pass ``sd`` (k,)
    directly (e.g. a code-mandated design spectrum).  ``zeta`` must match
    what the spectrum was computed with — it enters the CQC correlation.

    ``combination``: ``"srss"`` | ``"cqc"`` | ``"abssum"`` (see module
    docstring for when each is exact/bounding).
    """
    omega_sq = jnp.asarray(modal.omega_sq)
    omegas = jnp.sqrt(jnp.maximum(omega_sq, 0.0))
    if bool(jnp.any(omegas <= omega_floor)):
        raise ValueError(
            "response-spectrum analysis needs strictly positive modal "
            "frequencies (rigid ω ≈ 0 modes have unbounded relative "
            "displacement); pin the structure or drop rigid modes"
        )
    if (spectrum is None) == (sd is None):
        raise ValueError("pass exactly one of spectrum= or sd=")
    if sd is None:
        sd = spectrum.sd
    sd = jnp.asarray(sd, jnp.float32)
    if sd.shape != omegas.shape:
        raise ValueError(
            f"sd shape {sd.shape} must match the {omegas.shape[0]} modes "
            "(evaluate the spectrum at the modal frequencies)"
        )
    part = participation_factors(modal, mass, direction)
    modes = jnp.asarray(modal.modes)  # (k, N, d)
    r_fields = (part.factors * sd)[:, None, None] * modes  # (k, N, d)
    k = omegas.shape[0]
    eye = jnp.eye(k, dtype=jnp.float32)
    if combination == "abssum":
        peak = jnp.sum(jnp.abs(r_fields), axis=0)
        rho = eye
    elif combination == "srss":
        peak = jnp.sqrt(jnp.sum(r_fields * r_fields, axis=0))
        rho = eye
    elif combination == "cqc":
        rho = cqc_correlation(omegas, zeta)
        quad = jnp.einsum(
            "ij,ind,jnd->nd", rho, r_fields, r_fields,
            precision=jax.lax.Precision.HIGHEST,
        )
        # ρ is positive semi-definite in exact arithmetic (it is a
        # correlation matrix); clamp f32 round-off at machine scale.
        peak = jnp.sqrt(jnp.maximum(quad, 0.0))
    else:
        raise ValueError(
            f"unknown combination {combination!r} "
            "(srss | cqc | abssum)"
        )
    return RSResult(
        peak=peak, modal_peaks=r_fields, sd=sd,
        factors=part.factors, rho=rho, captured=part.captured,
    )
