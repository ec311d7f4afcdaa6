# coding=utf-8
"""Independent numpy oracle of the reference's step semantics.

A from-scratch, loop-level numpy implementation of the reference's simulation
step (explicit analytic, explicit autodiff-equivalent, implicit Jacobi/CG +
advect_implicit), written directly from the behavioral spec in SURVEY.md §3 —
deliberately *not* sharing any code with fem_tpu so trajectory agreement is
meaningful evidence of parity.  float64 throughout (the oracle is the
accuracy gold standard; fem_tpu runs f32).
"""

from __future__ import annotations

import numpy as np


class Oracle:
    def __init__(self, vertices, elements, rho, mu, lam, damping):
        self.idx = np.asarray(elements, np.int64)
        self.d = vertices.shape[1]
        self.n = vertices.shape[0]
        self.mu, self.lam, self.damping = mu, lam, damping
        pos = np.asarray(vertices, np.float64)
        d = self.d
        # elements_init semantics (object.py:346-362)
        r = np.stack(
            [
                np.stack([pos[self.idx[:, j + 1], i] - pos[self.idx[:, 0], i]
                          for j in range(d)], axis=-1)
                for i in range(d)
            ],
            axis=-2,
        )  # (E, d, d) columns = edges
        if d == 2:
            vol = 0.5 * np.abs(r[:, 0, 0] * r[:, 1, 1] - r[:, 1, 0] * r[:, 0, 1])
        else:
            vol = np.abs(np.linalg.det(r)) / 6.0
        self.vol = vol
        self.ref_inv = np.linalg.inv(r)
        self.mass = np.zeros(self.n)
        for e in range(self.idx.shape[0]):
            for v in self.idx[e]:
                self.mass[v] += vol[e] * rho / (d + 1)
        self.pos = pos.copy()
        self.vel = np.zeros_like(pos)
        self.vel_g = np.zeros_like(pos)

    # -- shared element quantities ---------------------------------------
    def _F(self):
        d = self.d
        X = np.stack(
            [self.pos[self.idx[:, j + 1]] - self.pos[self.idx[:, 0]]
             for j in range(d)],
            axis=-1,
        )  # (E, d, d)
        return X @ self.ref_inv

    def grad_columns(self):
        """Per-element energy-gradient columns H = V·P(F)·R⁻ᵀ
        (explicit.py:23-41 semantics, unclamped log)."""
        F = self._F()
        F_inv_T = np.swapaxes(np.linalg.inv(F), -1, -2)
        log_j = np.log(np.linalg.det(F))[:, None, None]
        P = self.mu * F - self.mu * F_inv_T + self.lam * log_j * F_inv_T
        return self.vol[:, None, None] * (
            P @ np.swapaxes(self.ref_inv, -1, -2)
        )

    def hessian_blocks(self):
        """Per-element decoupled Hessian blocks K_e (implicit.py:114-150:
        dF = R⁻¹, logJ clamped at 1e-4)."""
        F = self._F()
        F_inv = np.linalg.inv(F)
        F_inv_T = np.swapaxes(F_inv, -1, -2)
        log_j = np.log(np.maximum(np.linalg.det(F), 1e-4))[:, None, None]
        dF = self.ref_inv
        blk = (
            self.mu * dF
            + (self.mu - self.lam * log_j)
            * (F_inv_T @ np.swapaxes(dF, -1, -2) @ F_inv_T)
            + self.lam
            * np.trace(F_inv @ dF, axis1=-2, axis2=-1)[:, None, None]
            * F_inv_T
        )
        return -self.vol[:, None, None] * (
            blk @ np.swapaxes(self.ref_inv, -1, -2)
        )

    def force_columns(self):
        """Per-element implicit rhs force columns (implicit.py:65-107:
        the λ/2·log det(FᵀF) form)."""
        F = self._F()
        F_inv_T = np.swapaxes(np.linalg.inv(F), -1, -2)
        P = (
            self.mu * F
            - self.mu * F_inv_T
            + self.lam / 2
            * np.log(np.linalg.det(np.swapaxes(F, -1, -2) @ F))[:, None, None]
            * F_inv_T
        )
        return -self.vol[:, None, None] * (
            P @ np.swapaxes(self.ref_inv, -1, -2)
        )

    def _grad(self):
        """Assembled energy gradient (explicit.py:23-49 semantics)."""
        H = self.grad_columns()
        g = np.zeros_like(self.pos)
        for e in range(self.idx.shape[0]):
            f0 = np.zeros(self.d)
            for j in range(self.d):
                fj = H[e, :, j]
                g[self.idx[e, j + 1]] += fj
                f0 -= fj
            g[self.idx[e, 0]] += f0
        return g

    # -- advection (kinematic.py:14-45) ----------------------------------
    def kinematic(self, grad, dt, g_dir, blocks):
        self.vel += (np.asarray(g_dir) * 9.8 - grad / self.mass[:, None]) * dt
        self.vel *= np.exp(-dt * self.damping)
        for k in range(self.d):
            low = (self.pos[:, k] < 0) & (self.vel[:, k] < 0)
            self.vel[low, k] = 0.0
            hi = (self.pos[:, k] > 1) & (self.vel[:, k] > 0)
            self.vel[hi, k] = 0.0
        for center, radius in blocks:
            if radius <= 0:
                continue
            disp = self.pos - np.asarray(center)
            inside = np.linalg.norm(disp, axis=1) < radius
            toward = np.einsum("ni,ni->n", self.vel, -disp) > 0
            hit = inside & toward
            coeff = np.einsum("ni,ni->n", self.vel, disp) / np.maximum(
                np.einsum("ni,ni->n", disp, disp), 1e-300
            )
            self.vel[hit] -= coeff[hit, None] * disp[hit]
        self.pos += self.vel * dt

    def advect_implicit(self, dt, g_dir, blocks):
        """implicit.py:407-438 semantics incl. the vel_g quirk."""
        self.vel_g += np.asarray(g_dir) * 9.8 * dt
        decay = np.exp(-dt * self.damping)
        self.vel *= decay
        self.vel_g *= decay
        v = self.vel + self.vel_g
        for k in range(self.d):
            low = (self.pos[:, k] < 0) & (v[:, k] < 0)
            self.vel[low, k] = 0.0
            self.vel_g[low, k] = 0.0
            v[low, k] = 0.0
            hi = (self.pos[:, k] > 1) & (v[:, k] > 0)
            self.vel[hi, k] = 0.0  # NOT vel_g (implicit.py:422)
            v[hi, k] = 0.0
        for center, radius in blocks:
            if radius <= 0:
                continue
            disp = self.pos - np.asarray(center)
            inside = np.linalg.norm(disp, axis=1) < radius
            toward = np.einsum("ni,ni->n", v, -disp) > 0
            hit = inside & toward
            dd = np.einsum("ni,ni->n", disp, disp)
            for arr in (v, self.vel, self.vel_g):
                coeff = np.einsum("ni,ni->n", arr, disp) / np.maximum(dd, 1e-300)
                arr[hit] -= coeff[hit, None] * disp[hit]
        self.pos += v * dt

    # -- implicit solve (implicit.py:64-404) ------------------------------
    def _dense_system(self, dt):
        d, n = self.d, self.n
        K = self.hessian_blocks()
        A = np.zeros((n, n, d, d))
        for e in range(self.idx.shape[0]):
            v0 = self.idx[e, 0]
            for i in range(1, d + 1):
                vi = self.idx[e, i]
                A[vi, vi] += K[e]
                A[vi, v0] -= K[e]
                A[v0, vi] -= K[e]
                A[v0, v0] += K[e]
        A = -(dt * dt) * A / self.mass[:, None, None, None]
        A[np.arange(n), np.arange(n)] += np.eye(d)
        Ad = A.transpose(0, 2, 1, 3).reshape(n * d, n * d)

        # b = v + dt M^-1 f  (implicit.py:65-107)
        cols = self.force_columns()
        b = self.vel.copy()
        for e in range(self.idx.shape[0]):
            f0 = np.zeros(d)
            for j in range(d):
                fj = cols[e, :, j]
                f0 -= fj
                b[self.idx[e, j + 1]] += dt / self.mass[self.idx[e, j + 1]] * fj
            b[self.idx[e, 0]] += dt / self.mass[self.idx[e, 0]] * f0
        return Ad, b.reshape(-1)

    def solve_cg(self, dt, preconditioned=1):
        Ad, b = self._dense_system(dt)
        if preconditioned:
            op, rhs = Ad.T @ Ad, Ad.T @ b
        else:
            op, rhs = Ad, b
        x = b.copy()
        r = rhs - op @ x
        dvec = r.copy()
        delta = float(r @ r)
        it = 0
        while it < 500 and delta > 1e-5:
            q = op @ dvec
            alpha = delta / float(dvec @ q)
            x = x + alpha * dvec
            r = r - alpha * q
            dn = float(r @ r)
            dvec = r + (dn / delta) * dvec
            delta = dn
            it += 1
        self.cg_iterations = it
        self.vel = x.reshape(self.n, self.d)

    def solve_jacobi(self, dt, sweep="serial"):
        """Weighted Jacobi with rollback; the relaxation anchor persists
        across steps exactly like the reference's never-reset past_vec_x.

        sweep="serial" (default, the reference's actual execution): the
        particle loop of jacobi_iter_field_once runs serially inside the
        kernel's serial flow, so row i reads x[j] already updated this sweep
        for j < i; the row residual uses the full old x_i (the j-loop runs
        before the component loop) with only the scalar diagonal added back.
        sweep="snapshot": every row reads the previous iterate (the
        framework's parallel extension).
        """
        Ad, b = self._dense_system(dt)
        n = b.shape[0]
        d = self.d
        past_x = getattr(self, "_jacobi_past", None)
        past = np.zeros(n) if past_x is None else past_x.reshape(-1).copy()
        x = 0.5 * b
        err = np.linalg.norm(b - Ad @ x)
        p_err = err
        diag = np.diag(Ad)
        it = 0
        while err > 1e-5 and it < 20000:
            if sweep == "serial":
                x1 = x.copy()
                for i in range(self.n):
                    rows = slice(i * d, (i + 1) * d)
                    ax = Ad[rows] @ x1  # rows j<i updated, row i still old
                    for k in range(d):
                        a_ii = diag[i * d + k]
                        if abs(a_ii) < 1e-6:
                            x1[i * d + k] = 0.0
                        else:
                            num = b[i * d + k] - ax[k] + a_ii * x1[i * d + k]
                            x1[i * d + k] = (
                                0.75 * num / a_ii + 0.25 * past[i * d + k]
                            )
            else:
                resid = b - Ad @ x
                num = resid + diag * x
                x1 = np.where(
                    np.abs(diag) < 1e-6, 0.0, 0.75 * num / np.where(
                        np.abs(diag) < 1e-6, 1.0, diag
                    ) + 0.25 * past
                )
            err = np.linalg.norm(b - Ad @ x1)
            it += 1
            if err >= p_err:
                x = past.copy()
                break
            p_err = err
            x = x1
            past = x1.copy()
        self.vel = x.reshape(self.n, self.d)
        self._jacobi_past = past

    # -- full steps -------------------------------------------------------
    def step_explicit(self, dt, g_dir, blocks):
        self.kinematic(self._grad(), dt, g_dir, blocks)

    def step_implicit_cg(self, dt, g_dir, blocks, preconditioned=1):
        self.solve_cg(dt, preconditioned)
        self.advect_implicit(dt, g_dir, blocks)

    def step_implicit_jacobi(self, dt, g_dir, blocks, sweep="serial"):
        self.solve_jacobi(dt, sweep)
        self.advect_implicit(dt, g_dir, blocks)
