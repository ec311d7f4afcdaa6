# coding=utf-8
"""Arc-length (Riks/Crisfield) continuation: equilibrium paths through
limit points.

Framework extension (the reference is a dynamics-only simulator; the
statics solver solvers/static.py can only converge to stable equilibria):
trace the full equilibrium path (x(s), λ(s)) of the one-parameter family

    g(x) − λ·f = 0,          g = ∂U/∂x  (internal force),  f = load pattern,

THROUGH folds of the path — snap-through of shallow arches, post-buckling
descent — where load control (λ prescribed) jumps dynamically and
displacement control is not expressible.  The classic method: augment the
unknowns with λ and constrain each increment to a sphere in (Δx, Δλ)
space,

    ‖Δx‖² + ψ²·s_f²·Δλ² = Δl²,

(Crisfield's spherical constraint; s_f = ‖K₀⁻¹f‖ makes the two terms
commensurate and ψ the usual O(1) knob), so the continuation parameter is
arc length, which is regular at limit points where λ is not.

Solver design — and an honest negative result.  The corrector solves
K·δx_r = −r and K·δx_f = f sit ON the fold, where K is singular then
indefinite; a matrix-free Krylov treatment was built first and MEASURED
to stall: restarted GMRES on the exact HVP of a bending-dominated arch
plateaus at relative residual ≈ 0.26 within 320 applies, and the
resulting inexact-Newton corrector stalls its max-residual at ~6× the
f32 assembly floor (trace in the session record) — soft bending modes
are precisely what an unpreconditioned Krylov cannot reach.  Path
following needs factorization-grade solves, which is how production
arc-length implementations work.  So the tangent here is DIRECT:

  * per-element exact Hessians of the elastic energy by ``jax.hessian``
    of the local (d+1)·d-coordinate element energy, vmapped over all
    elements — one batched computation per iterate,
    exact for every material (incl. corotated through the Higham polar);
  * assembled into a host scipy CSR (indices precomputed once) with the
    Dirichlet projection applied element-wise, and factorized by sparse
    f64 LU — O(E) assembly, one factorization shared by both corrector
    solves.  Continuation is an offline analysis: the host LU at FEM
    bandwidths handles 1e5+ DOFs in seconds (a device-side f64 solve is
    an open item).

δλ per corrector comes from the constraint's quadratic (Crisfield), root
picked to continue forward, with a linearized (Riks) fallback when the
discriminant dips negative.  The host loop adapts Δl: halve on a failed
step, grow 1.3× on fast convergence.

Second measured fact: the whole analysis runs in FLOAT64 on the host CPU
(the ``modal_refine_f64`` precedent).  In f32, the residual evaluation's
position-quantization noise — ε₃₂·|x|·(μ+λ)·V·‖R⁻¹‖², ≈1e-2 on the
thin-element test arch — exceeded the corrector target by ~6×: with
EXACT f64 tangent solves the increment converged to ‖δx‖ ~ 2e-7 while
the f32 max-residual FLUCTUATED in [7e-3, 1.2e-2] (session trace).
Path following needs residuals the evaluation can actually resolve;
continuation is an offline, host-paced analysis, so f64 is the honest
default, and ``tol`` becomes a real tolerance instead of a noise floor.

Dirichlet pins are required; ``f`` is projected to the free subspace.
Bifurcation points (symmetry-breaking) are not branch-switched — the
tracer follows the primary branch; seed an imperfection to select one.

Validated on a shallow-arch snap-through in tests/test_riks.py: the λ
history rises to a limit point, DESCENDS while the crown keeps moving
down (the segment no load- or displacement-controlled solver can
produce), and re-stiffens on the inverted branch; every recorded point is
verified to be a true equilibrium of its own λ.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from fem_tpu.models.state import FemObject
from fem_tpu.ops.assembly import assemble_for, element_contrib_full
from fem_tpu.ops.element import energy_density, explicit_grad_columns


class ArcLengthResult(NamedTuple):
    """Recorded equilibrium path.

    ``lam``: (n_pts,) load multipliers λ along the path (row 0 = 0).
    ``control``: (n_pts,) control displacement — position component of
    ``control_dof`` minus its initial value.
    ``residuals``: (n_pts,) max |g − λf| at each recorded point.
    ``pos``: (N, d) final configuration.
    ``path_pos``: (n_pts, N, d) full configurations, or None when
    ``record_path=False``.
    ``steps_taken``: accepted steps; ``retries``: total Δl halvings;
    ``tol_used``: the effective absolute residual tolerance.
    """

    lam: jnp.ndarray
    control: jnp.ndarray
    residuals: jnp.ndarray
    pos: jnp.ndarray
    path_pos: Optional[jnp.ndarray]
    steps_taken: int
    retries: int
    tol_used: float = 0.0


def make_element_hessian_fn(obj: FemObject):
    """Jitted ``pos -> (E, m, m)`` exact per-element elastic Hessians,
    m = (d+1)·d local DOFs: batched ``jax.hessian`` of the local element
    energy V_e·φ(D·R⁻¹) — material-generic through energy_density."""
    d = int(obj.ref_inv.shape[-1])

    def local_energy(x_flat, rinv, vol):
        x = x_flat.reshape(d + 1, d)
        dm = jnp.matmul(
            (x[1:] - x[0][None, :]).T, rinv,
            precision=jax.lax.Precision.HIGHEST,
        )
        return vol * energy_density(dm, obj.mu, obj.s_lambda, obj.material)

    hess = jax.vmap(jax.hessian(local_energy), in_axes=(0, 0, 0))

    @jax.jit
    def fn(pos, elem, rinv, vol):
        m = (d + 1) * d
        x_loc = pos[elem].reshape(-1, m)
        return hess(x_loc, rinv, vol)

    def run(pos):
        return fn(pos, obj.element_indices, obj.ref_inv, obj.volume)

    return run


class _SparseTangent:
    """Host-side exact tangent stiffness: assemble + f64 sparse LU."""

    def __init__(self, obj: FemObject):
        import scipy.sparse as sp

        self._sp = sp
        self.obj = obj
        elem = np.asarray(obj.element_indices)
        e_cnt, dp1 = elem.shape
        d = dp1 - 1
        self.nd = int(obj.particle_cnt) * d
        m = dp1 * d
        gdof = (elem[:, :, None] * d + np.arange(d)[None, None, :]).reshape(
            e_cnt, m
        )
        self.rows = np.repeat(gdof, m, axis=1).ravel()
        self.cols = np.tile(gdof, (1, m)).ravel()
        free = np.repeat(
            np.asarray(obj.free_mask)[:, 0].astype(bool), d
        )
        self.free = free
        self.mask_elem = free[gdof].astype(np.float64)  # (E, m)
        self.hess_fn = make_element_hessian_fn(obj)

    def factor(self, pos: jnp.ndarray):
        """Assemble K(pos) with Dirichlet projection (P·K·P + (I−P)) and
        return a solve(rhs (N,d)) -> (N,d) closure over the f64 LU."""
        import scipy.sparse.linalg as spla

        h = np.asarray(self.hess_fn(pos), np.float64)
        # (np.asarray of a CPU jax array is a read-only zero-copy view)
        h = h * (self.mask_elem[:, :, None] * self.mask_elem[:, None, :])
        k = self._sp.coo_matrix(
            (h.ravel(), (self.rows, self.cols)), shape=(self.nd, self.nd)
        ).tocsc()
        held = ~self.free
        if held.any():
            idx = np.where(held)[0]
            k = k + self._sp.coo_matrix(
                (np.ones(idx.size), (idx, idx)), shape=k.shape
            ).tocsc()
        lu = spla.splu(k)
        n = self.nd // pos.shape[1]

        def solve(rhs: np.ndarray) -> np.ndarray:
            out = lu.solve(np.asarray(rhs, np.float64).reshape(self.nd))
            out = np.where(self.free, out, 0.0)
            return out.reshape(n, -1)

        return solve


def arc_length_path(
    obj: FemObject,
    pos0: jnp.ndarray,
    f_pattern: jnp.ndarray,
    n_steps: int = 40,
    dlam0: float = 0.05,
    lam_max: Optional[float] = None,
    psi: float = 1.0,
    max_corr: int = 12,
    tol: float = 1e-6,
    max_retries: int = 4,
    record_path: bool = True,
    control_dof: Optional[Tuple[int, int]] = None,
) -> ArcLengthResult:
    """Trace the equilibrium path of ``obj`` under load λ·``f_pattern``.

    ``dlam0`` sets the FIRST step's intended Δλ (the arc radius derives
    from it via the tangent); later steps adapt.  Stops after ``n_steps``
    accepted steps or once λ ≥ ``lam_max`` (if given).  ``tol`` is
    relative to the applied load scale max|f|; the whole analysis runs
    in float64 on the host CPU (see module docstring), so 1e-6 is a real
    target.  ``control_dof`` = (vertex, axis) to record; defaults to the
    largest-|f| DOF.  Returned arrays are float64.
    """
    if obj.free_mask is None:
        raise ValueError(
            "arc_length_path requires Dirichlet constraints "
            "(ObjectConfig.pin_boxes / obj.free_mask)"
        )
    from fem_tpu.solvers.modal import _cast_inexact

    with jax.enable_x64(True):
        cpu = jax.devices("cpu")[0]
        with jax.default_device(cpu):
            obj64 = _cast_inexact(obj, jnp.float64)
            pos64 = jax.device_put(
                jnp.asarray(np.asarray(pos0), jnp.float64), cpu
            )
            f64 = jax.device_put(
                jnp.asarray(np.asarray(f_pattern), jnp.float64), cpu
            )
            return _arc_length_impl(
                obj64, pos64, f64, n_steps, dlam0, lam_max, psi,
                max_corr, tol, max_retries, record_path, control_dof,
            )


def _arc_length_impl(
    obj, pos0, f_pattern, n_steps, dlam0, lam_max, psi, max_corr, tol,
    max_retries, record_path, control_dof,
) -> ArcLengthResult:
    n, d = pos0.shape
    free = obj.free_mask.astype(pos0.dtype)  # (N, 1)
    f = np.asarray(jnp.asarray(f_pattern) * free, np.float64)
    f_scale = float(np.max(np.abs(f)))
    tol_eff = tol * f_scale
    if control_dof is None:
        flat = int(np.argmax(np.abs(f)))
        control_dof = (flat // d, flat % d)
    ci, cj = control_dof

    @jax.jit
    def residual_dev(p: jnp.ndarray, lam: jnp.ndarray) -> jnp.ndarray:
        cols = explicit_grad_columns(
            p, obj.element_indices, obj.ref_inv, obj.volume,
            obj.mu, obj.s_lambda, obj.material,
        )
        g = assemble_for(obj, element_contrib_full(cols), None)
        return free * (g - lam * jnp.asarray(f, pos0.dtype))

    def residual(p: np.ndarray, lam: float) -> np.ndarray:
        return np.asarray(
            residual_dev(jnp.asarray(p, pos0.dtype), jnp.asarray(lam, pos0.dtype)),
            np.float64,
        )

    tangent = _SparseTangent(obj)

    def trial_step(x, lam, prev_dx, prev_dlam, dl, s_f):
        """Predictor + full-Newton Crisfield correctors (host f64)."""
        psi2 = psi * psi * s_f * s_f
        solve = tangent.factor(jnp.asarray(x, pos0.dtype))
        dxt = solve(f)
        denom = np.sqrt(np.sum(dxt * dxt) + psi2)
        sgn = 1.0 if (np.sum(dxt * prev_dx) + psi2 * prev_dlam) >= 0 else -1.0
        dlam = sgn * dl / denom
        dx = dlam * dxt
        n_corr = 0
        rmax = np.inf
        for _ in range(max_corr):
            xt = x + dx
            r = residual(xt, lam + dlam)
            rmax = float(np.max(np.abs(r)))
            if not np.isfinite(rmax):
                return dx, dlam, False, rmax, n_corr
            if rmax <= tol_eff:
                return dx, dlam, True, rmax, n_corr
            solve = tangent.factor(jnp.asarray(xt, pos0.dtype))
            dx_r = solve(-r)
            dx_f = solve(f)
            a = np.sum(dx_f * dx_f) + psi2
            b = 2.0 * (np.sum((dx + dx_r) * dx_f) + psi2 * dlam)
            c = (
                np.sum((dx + dx_r) * (dx + dx_r))
                + psi2 * dlam * dlam
                - dl * dl
            )
            disc = b * b - 4.0 * a * c
            if disc >= 0.0:
                sq = np.sqrt(disc)
                r1 = (-b + sq) / (2.0 * a)
                r2 = (-b - sq) / (2.0 * a)

                def align(z):
                    return np.sum((dx + dx_r + z * dx_f) * dx)

                dlam_c = r1 if align(r1) >= align(r2) else r2
            else:
                den = np.sum(dx * dx_f) + psi2 * dlam
                dlam_c = -np.sum(dx * dx_r) / (
                    den if abs(den) > 1e-300 else 1e-300
                )
            dx = dx + dx_r + dlam_c * dx_f
            dlam = dlam + dlam_c
            n_corr += 1
        r = residual(x + dx, lam + dlam)
        rmax = float(np.max(np.abs(r)))
        return dx, dlam, bool(np.isfinite(rmax) and rmax <= tol_eff), rmax, n_corr

    # --- host continuation loop (Δl adaptivity + retry) ------------------
    x = np.asarray(pos0, np.float64)
    solve0 = tangent.factor(pos0)
    dxt0 = solve0(f)
    s_f = max(float(np.linalg.norm(dxt0)), 1e-30)
    dl = float(dlam0) * np.sqrt(s_f * s_f + psi * psi * s_f * s_f)
    dl_max = 8.0 * dl

    lam = 0.0
    prev_dx = np.zeros_like(x)
    prev_dlam = 1.0
    c0 = float(x[ci, cj])

    lams = [0.0]
    controls = [0.0]
    resids = [float(np.max(np.abs(residual(x, 0.0))))]
    path = [x.copy()] if record_path else None
    accepted = 0
    retries = 0
    fails_in_row = 0
    while accepted < n_steps:
        dx, dlam, ok, rmax, n_corr = trial_step(
            x, lam, prev_dx, prev_dlam, dl, s_f
        )
        if not ok:
            retries += 1
            fails_in_row += 1
            if fails_in_row > max_retries:
                break
            dl *= 0.5
            continue
        fails_in_row = 0
        x = x + dx
        lam = lam + dlam
        prev_dx, prev_dlam = dx, dlam
        accepted += 1
        lams.append(float(lam))
        controls.append(float(x[ci, cj]) - c0)
        resids.append(rmax)
        if record_path:
            path.append(x.copy())
        if n_corr <= 4:
            dl = min(dl * 1.3, dl_max)
        if lam_max is not None and lam >= lam_max:
            break

    return ArcLengthResult(
        lam=jnp.asarray(lams),
        control=jnp.asarray(controls),
        residuals=jnp.asarray(resids),
        pos=jnp.asarray(x, pos0.dtype),
        path_pos=(
            jnp.asarray(np.stack(path), pos0.dtype) if record_path else None
        ),
        steps_taken=accepted,
        retries=retries,
        tol_used=float(tol_eff),
    )
