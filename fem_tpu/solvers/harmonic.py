# coding=utf-8
"""Harmonic (steady-state frequency response) and modal transient analysis.

Framework extension (the reference is a time-domain dynamics simulator
only — /root/reference/main.py integrates substeps; it has no frequency-
domain capability): the classic linear-dynamics analysis pair built on the
modal basis from solvers/modal.py —

  * :func:`harmonic_response` — the steady-state complex response
    x̂(ω)·e^{iωt} of the damped linear system

        M ẍ + C ẋ + K x = F̂ cos(ωt),       C = α·M + β·K  (Rayleigh)

    by modal superposition: with M-orthonormal modes φᵢ (φᵢᵀMφⱼ = δᵢⱼ,
    exactly what ModalResult carries) each mode responds independently,

        q̂ᵢ(ω) = φᵢᵀF̂ / (ωᵢ² − ω² + i·ω·cᵢ),     cᵢ = α + β·ωᵢ²,

    so a full frequency sweep costs one (nf × k) complex divide plus one
    matrix product back to physical space — no per-frequency solves.

  * :func:`modal_transient` — time integration of the same reduced system
    with the EXACT one-step propagator: per mode the 2×2 companion
    A = [[0, 1], [−ωᵢ², −cᵢ]] is advanced by its matrix exponential, with
    the forced step taken from the augmented-matrix identity
    expm([[A, B],[0, 0]]) = [[e^{Adt}, A⁻¹(e^{Adt}−I)B], [0, I]] — exact
    for piecewise-constant forcing and, unlike the augmented form's naive
    A⁻¹, well-defined for the rigid-body modes (ω = 0, singular A).
    The whole rollout is one ``lax.scan`` over (k,)-vector states —
    a reduced-order model whose step cost is O(k), independent of mesh
    size.

Both are linear analyses about the configuration the modes were computed
at; amplitudes are valid in the small-deformation regime (the nonlinear
time-domain solvers remain the large-deformation path).

Validated against a dense complex direct solve (K − ω²M + iωC)x̂ = F̂ and
closed-form damped-oscillator solutions in tests/test_harmonic.py.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from fem_tpu.solvers.modal import ModalResult


class HarmonicResult(NamedTuple):
    """Steady-state response over a frequency sweep.

    ``freqs``: (nf,) excitation frequencies in Hz.
    ``coeffs``: (nf, k) complex modal coordinates q̂ᵢ(ω).
    ``amplitude``: (nf, N, dim) |x̂| per DOF, or None with ``fields=False``.
    ``phase``: (nf, N, dim) arg(x̂) in radians, or None with
    ``fields=False`` (reconstruct later via :func:`reconstruct_field`).
    """

    freqs: jnp.ndarray
    coeffs: jnp.ndarray
    amplitude: Optional[jnp.ndarray]
    phase: Optional[jnp.ndarray]


def _modal_damping(
    omega_sq: jnp.ndarray,
    alpha: float,
    beta: float,
    zeta: Optional[jnp.ndarray],
) -> jnp.ndarray:
    """Per-mode viscous coefficient cᵢ (q̈ + c q̇ + ω² q): Rayleigh
    C = αM + βK gives cᵢ = α + β·ωᵢ²; ``zeta`` (modal damping ratios)
    overrides with cᵢ = 2·ζᵢ·ωᵢ."""
    if zeta is not None:
        z = jnp.broadcast_to(jnp.asarray(zeta), omega_sq.shape)
        return 2.0 * z * jnp.sqrt(jnp.maximum(omega_sq, 0.0))
    return alpha + beta * omega_sq


def harmonic_response(
    modal: ModalResult,
    f_hat: jnp.ndarray,
    freqs_hz: jnp.ndarray,
    alpha: float = 0.0,
    beta: float = 0.0,
    zeta: Optional[jnp.ndarray] = None,
    fields: bool = True,
) -> HarmonicResult:
    """Steady-state response to F̂·cos(ωt) over a sweep of frequencies.

    ``modal``: eigenpairs from modal_analysis / modal_analysis_chebyshev
    (modes must be M-orthonormal — both produce that).  ``f_hat``: (N, d)
    real load amplitude.  ``freqs_hz``: (nf,) excitation frequencies.
    ``alpha``/``beta``: Rayleigh damping C = αM + βK (β matches the
    dynamics paths' ``damping_beta``); ``zeta``: per-mode damping ratios,
    overriding Rayleigh.  ``fields=False`` skips the (nf, N, d) field
    reconstruction (large meshes / dense sweeps) — ``coeffs`` plus
    :func:`reconstruct_field` recover any frequency's field later.

    Truncation note: the sweep is exact for the span of the supplied modes;
    response components outside it (high-frequency quasi-static
    contribution) are missing — standard modal-superposition behavior, so
    use k comfortably above the sweep's band.
    """
    omega_sq = jnp.asarray(modal.omega_sq)
    modes = jnp.asarray(modal.modes)  # (k, N, d)
    k = modes.shape[0]
    w = 2.0 * jnp.pi * jnp.asarray(freqs_hz, omega_sq.dtype)  # (nf,)
    c = _modal_damping(omega_sq, alpha, beta, zeta)  # (k,)
    # Modal participation of the load: pᵢ = φᵢᵀ F̂.
    p = jnp.einsum(
        "knd,nd->k", modes, jnp.asarray(f_hat),
        precision=jax.lax.Precision.HIGHEST,
    )
    denom = (
        (omega_sq[None, :] - (w**2)[:, None]).astype(jnp.complex64)
        + 1j * (w[:, None] * c[None, :]).astype(jnp.complex64)
    )
    coeffs = p[None, :].astype(jnp.complex64) / denom  # (nf, k)
    amplitude = phase = None
    if fields:
        x_hat = jnp.einsum(
            "fk,knd->fnd", coeffs, modes.astype(jnp.complex64),
            precision=jax.lax.Precision.HIGHEST,
        )
        amplitude = jnp.abs(x_hat)
        phase = jnp.angle(x_hat)
    return HarmonicResult(
        freqs=jnp.asarray(freqs_hz), coeffs=coeffs,
        amplitude=amplitude, phase=phase,
    )


def reconstruct_field(modal: ModalResult, coeffs: jnp.ndarray) -> jnp.ndarray:
    """Physical (complex) displacement field(s) from modal coordinates:
    coeffs (..., k) → (..., N, d)."""
    modes = jnp.asarray(modal.modes).astype(jnp.complex64)
    return jnp.einsum(
        "...k,knd->...nd", jnp.asarray(coeffs), modes,
        precision=jax.lax.Precision.HIGHEST,
    )


class ModalTransientResult(NamedTuple):
    """Reduced-order rollout: ``q``/``q_dot`` are (steps+1, k) modal
    coordinate trajectories (row 0 = initial condition); ``times`` (steps+1,)."""

    times: jnp.ndarray
    q: jnp.ndarray
    q_dot: jnp.ndarray


def modal_transient(
    modal: ModalResult,
    dt: float,
    steps: int,
    q0: Optional[jnp.ndarray] = None,
    q_dot0: Optional[jnp.ndarray] = None,
    force: Optional[Callable[[jnp.ndarray], jnp.ndarray]] = None,
    f_const: Optional[jnp.ndarray] = None,
    alpha: float = 0.0,
    beta: float = 0.0,
    zeta: Optional[jnp.ndarray] = None,
) -> ModalTransientResult:
    """Exact-propagator time integration of the modal reduced system.

    Per mode i the ODE q̈ᵢ + cᵢq̇ᵢ + ωᵢ²qᵢ = pᵢ(t) advances by the exact
    2×2 exponential map, with pᵢ held constant over each step (sampled at
    the step start): unconditionally stable at ANY dt and exact for
    constant/slowly-varying loads — the reduced-order complement to the
    full nonlinear integrators.

    ``force``: callable t → (N, d) load (projected onto the modes each
    step, traced under ``lax.scan`` — jax-transformable, static shapes);
    ``f_const``: constant (N, d) load alternative.  ``q0``/``q_dot0``:
    (k,) initial modal coordinates (project initial fields with
    φᵢᵀM·x — or use :func:`project_field`).
    """
    omega_sq = jnp.asarray(modal.omega_sq)
    modes = jnp.asarray(modal.modes)
    k = modes.shape[0]
    c = _modal_damping(omega_sq, alpha, beta, zeta)

    # Per-mode augmented exponential: expm([[A, B], [0, 0]]·dt) packs the
    # exact propagator E = e^{A·dt} and forced step S = ∫₀^dt e^{Aτ}B dτ
    # in one 3×3 exponential — finite for ω = 0 (rigid modes) where A is
    # singular and the textbook A⁻¹(E−I)B form is not.
    def make_prop(w2, ci):
        aug = jnp.array(
            [
                [0.0, 1.0, 0.0],
                [-w2, -ci, 1.0],
                [0.0, 0.0, 0.0],
            ],
            omega_sq.dtype,
        )
        m = jax.scipy.linalg.expm(aug * dt)
        return m[:2, :2], m[:2, 2]

    e_mat, s_vec = jax.vmap(make_prop)(omega_sq, c)  # (k,2,2), (k,2)

    q0 = jnp.zeros((k,), omega_sq.dtype) if q0 is None else jnp.asarray(q0)
    qd0 = (
        jnp.zeros((k,), omega_sq.dtype)
        if q_dot0 is None
        else jnp.asarray(q_dot0)
    )
    if f_const is not None and force is not None:
        raise ValueError("pass force= or f_const=, not both")
    p_const = (
        jnp.einsum(
            "knd,nd->k", modes, jnp.asarray(f_const),
            precision=jax.lax.Precision.HIGHEST,
        )
        if f_const is not None
        else jnp.zeros((k,), omega_sq.dtype)
    )

    def step(carry, t):
        q, qd = carry
        p = p_const
        if force is not None:
            p = p + jnp.einsum(
                "knd,nd->k", modes, force(t),
                precision=jax.lax.Precision.HIGHEST,
            )
        y = jnp.stack([q, qd], axis=-1)  # (k, 2)
        y_new = jnp.einsum(
            "kij,kj->ki", e_mat, y, precision=jax.lax.Precision.HIGHEST
        ) + s_vec * p[:, None]
        return (y_new[:, 0], y_new[:, 1]), (y_new[:, 0], y_new[:, 1])

    ts = jnp.arange(steps, dtype=omega_sq.dtype) * dt
    (_, _), (qs, qds) = jax.lax.scan(step, (q0, qd0), ts)
    times = jnp.concatenate([jnp.zeros((1,), ts.dtype), ts + dt])
    return ModalTransientResult(
        times=times,
        q=jnp.concatenate([q0[None], qs], axis=0),
        q_dot=jnp.concatenate([qd0[None], qds], axis=0),
    )


def project_field(
    modal: ModalResult, mass: jnp.ndarray, field: jnp.ndarray
) -> jnp.ndarray:
    """Modal coordinates of a physical field: qᵢ = φᵢᵀ·M·x (M-orthonormal
    modes make this the exact L²(M) projection).  ``mass``: (N,) lumped
    masses; ``field``: (N, d)."""
    modes = jnp.asarray(modal.modes)
    return jnp.einsum(
        "knd,nd->k", modes, mass[:, None] * jnp.asarray(field),
        precision=jax.lax.Precision.HIGHEST,
    )


class ParticipationResult(NamedTuple):
    """Modal participation factors for a rigid base-excitation direction.

    ``factors``: (k,) Γᵢ = φᵢᵀ·M·e (e = unit direction on every vertex).
    ``effective_mass``: (k,) Γᵢ² — the mass each mode carries in that
    direction (M-orthonormal modes make this exact).
    ``total_mass``: Σ mᵥ; ``captured``: Σ Γᵢ² / total — the standard
    "how much of the structure the retained modes represent" check
    (→ 1 as k → nd; codes demand ≳0.9 for seismic work).
    """

    factors: jnp.ndarray
    effective_mass: jnp.ndarray
    total_mass: jnp.ndarray
    captured: jnp.ndarray


def participation_factors(
    modal: ModalResult, mass: jnp.ndarray, direction
) -> ParticipationResult:
    """Participation factors Γᵢ = φᵢᵀM·e and effective modal masses Γᵢ²
    for a uniform excitation ``direction`` (d,) — the classic modal-basis
    adequacy metric (free DOFs only: pinned vertices carry no modal
    content by construction)."""
    modes = jnp.asarray(modal.modes)  # (k, N, d)
    e = jnp.asarray(direction, modes.dtype)
    e = e / jnp.linalg.norm(e)
    field = mass[:, None] * e[None, :]  # (N, d)
    gam = jnp.einsum(
        "knd,nd->k", modes, field, precision=jax.lax.Precision.HIGHEST
    )
    eff = gam * gam
    total = jnp.sum(mass)
    return ParticipationResult(
        factors=gam,
        effective_mass=eff,
        total_mass=total,
        captured=jnp.sum(eff) / total,
    )
