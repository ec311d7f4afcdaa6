# coding=utf-8
"""True-Newton backward Euler (``SimConfig.integrator="newton"`` extension,
solvers/newton.py).

The reference's implicit method is semi-implicit: ONE linearized solve per
substep (/root/reference/solver/implicit.py:201-223), which blows up when
κ = dt²‖K‖/m → 1 (the dt ~ h wall of large meshes).
The Newton integrator closes the nonlinear elastic residual
r(v) = (v − vₙ) − dt·M⁻¹·f(xₙ + dt·v) each substep; these tests pin

  * agreement with the semi-implicit path in stable regimes (both are
    backward-Euler-consistent: O(dt²) per-step difference),
  * rescue of the κ-blow-up reproducer that NaNs the reference integrator,
  * dissipativity (backward Euler never adds elastic+kinetic energy),
  * Dirichlet pins / prescribed-motion pins,
  * material-generic operation (stable NH, corotated),
  * loud rejection from the differentiable substeps.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from fem_tpu.models.state import Obstacles
from fem_tpu.ops.element import total_energy
from fem_tpu.sim import make_frame_fn, make_substep_fn
from fem_tpu.utils.config import ObjectConfig, SimConfig
from tests.utils import default_obstacles, make_2d_object, make_3d_object

G = (0.0, -1.0)


def _cfg(dt, **kw):
    base = dict(
        dim=2, delta_time=dt, sim_count=10, use_explicit_method=False,
        auto_diff=False, implicit_method=1, preconditioned=1, g_dir=G,
    )
    base.update(kw)
    return SimConfig(**base)


def no_obstacles(dim=2):
    return Obstacles(
        centers=jnp.zeros((1, dim), jnp.float32),
        radii=jnp.zeros((1,), jnp.float32),
    )


def test_integrator_validated():
    with pytest.raises(ValueError):
        _cfg(5e-4, integrator="bogus")


def test_matches_semi_implicit_in_stable_regime():
    """At a reference-stable dt both integrators approximate the same
    backward-Euler step; per-substep velocity difference is the
    linearization error O(dt²·‖K/m‖·‖Δx‖) — tiny on this mesh."""
    _, obj, state = make_2d_object(subdivisions=5)
    state = state.replace(
        vel=state.vel + jnp.asarray([[0.15, -0.3]], jnp.float32)
    )
    obs = default_obstacles()
    s_ref, _ = make_substep_fn(obj, _cfg(5e-4))(state, obs)
    s_new, aux = make_substep_fn(obj, _cfg(5e-4, integrator="newton"))(
        state, obs
    )
    diff = np.abs(np.asarray(s_ref.vel) - np.asarray(s_new.vel)).max()
    assert diff < 1e-4, diff
    # Converged: the reported residual is ‖P·r‖²_∞ ≤ newton_tol².
    assert float(aux.solver_residual) <= (1e-5) ** 2 + 1e-12


def test_trajectories_agree_over_horizon():
    """Over a 0.05-s horizon at stable dt the two integrators' trajectories
    agree to the f32 solve floor (measured ~2e-7 at every dt in
    [1e-4, 8e-4]: in this regime the single linearized solve already
    satisfies the nonlinear residual to below both tolerances, so Newton
    accepts it — the integrators genuinely coincide, not just converge)."""
    obs = default_obstacles()
    dt = 4e-4
    _, obj, s0 = make_2d_object(subdivisions=4)
    s0 = s0.replace(vel=s0.vel + jnp.asarray([[0.2, -0.4]], jnp.float32))
    f_a = make_substep_fn(obj, _cfg(dt))
    f_b = make_substep_fn(obj, _cfg(dt, integrator="newton"))
    sa = sb = s0
    for _ in range(int(round(0.05 / dt))):
        sa, _ = f_a(sa, obs)
        sb, _ = f_b(sb, obs)
    gap = np.abs(np.asarray(sa.pos) - np.asarray(sb.pos)).max()
    assert gap < 1e-5, gap


def test_rescues_kappa_blowup():
    """The κ ≈ 60 reproducer (tests/test_adaptive_dt.py): the reference
    integrator NaNs within a few frames; Newton stays finite through the
    same horizon AND beyond."""
    _, obj, s0 = make_2d_object(subdivisions=7, E=4e5)
    obs = default_obstacles()
    dt = 2e-3

    s = s0
    frame = make_frame_fn(obj, _cfg(dt))
    nan_frame = None
    for i in range(8):
        s, _ = frame(s, obs)
        if not np.isfinite(np.asarray(s.pos)).all():
            nan_frame = i
            break
    assert nan_frame is not None, "reproducer no longer blows up unguarded"

    s = s0
    frame_n = make_frame_fn(obj, _cfg(dt, integrator="newton"))
    for i in range(12):
        s, _ = frame_n(s, obs)
        assert np.isfinite(np.asarray(s.pos)).all(), f"newton NaN, frame {i}"


def test_backward_euler_dissipates_energy():
    """No gravity, no damping, no wall contact: elastic + kinetic energy is
    non-increasing under the fully implicit step (backward Euler is
    unconditionally dissipative — the property the semi-implicit integrator
    loses at κ → 1)."""
    _, obj, s0 = make_2d_object(subdivisions=5, damping=0.0, E=4e5)
    # Squeeze: inward radial velocity field.
    c = np.asarray(s0.pos).mean(axis=0)
    v0 = -(np.asarray(s0.pos) - c) * 8.0
    s = s0.replace(vel=jnp.asarray(v0))
    obs = no_obstacles()
    step = make_substep_fn(
        obj, _cfg(2e-3, g_dir=(0.0, 0.0), integrator="newton")
    )

    def total(s):
        u = float(
            total_energy(
                s.pos, obj.element_indices, obj.ref_inv, obj.volume,
                obj.mu, obj.s_lambda, obj.material,
            )
        )
        ke = 0.5 * float(
            jnp.sum(obj.mass[:, None] * (s.vel + s.vel_g) ** 2)
        )
        return u + ke

    e0 = total(s)
    e_prev = e0
    for i in range(30):
        s, _ = step(s, obs)
        e = total(s)
        # Never rises beyond the f32 energy-evaluation noise (the total
        # energy is a sum of ~φ·V terms with ~1e-4 relative cancellation;
        # measured bounce at the settled floor is ≤2e-4 absolute here).
        assert e <= e_prev * (1.0 + 1e-4) + 5e-4, (i, e_prev, e)
        e_prev = e
    # And the violent squeeze has genuinely dissipated: >99.9% gone.
    assert e_prev < 1e-3 * e0, (e0, e_prev)


def test_pins_held_and_prescribed_motion():
    """Pinned vertices stay put; 3-element pin boxes translate at the
    prescribed velocity — same contract as the semi-implicit projection."""
    _, obj, state = make_2d_object(
        subdivisions=4, center=(0.4, 0.5),
        pin_boxes=(((0.35, 0.695), (0.65, 0.705)),),
    )
    obs = no_obstacles()
    step = make_substep_fn(obj, _cfg(1e-3, integrator="newton"))
    pinned = np.asarray(obj.free_mask)[:, 0] == 0.0
    p0 = np.asarray(state.pos)[pinned]
    s = state
    for _ in range(20):
        s, _ = step(s, obs)
    np.testing.assert_array_equal(np.asarray(s.pos)[pinned], p0)
    assert not np.isnan(np.asarray(s.pos)).any()

    _, obj2, st2 = make_2d_object(
        subdivisions=4, center=(0.4, 0.5),
        pin_boxes=(((0.35, 0.695), (0.65, 0.705), (0.1, 0.0)),),
    )
    step2 = make_substep_fn(obj2, _cfg(1e-3, integrator="newton"))
    pinned2 = np.asarray(obj2.free_mask)[:, 0] == 0.0
    q0 = np.asarray(st2.pos)[pinned2]
    s2 = st2
    for _ in range(10):
        s2, _ = step2(s2, obs)
    np.testing.assert_allclose(
        np.asarray(s2.pos)[pinned2], q0 + [0.1 * 1e-3 * 10, 0.0],
        rtol=0, atol=1e-6,
    )


@pytest.mark.parametrize("material", ["stable_neo_hookean", "corotated"])
def test_material_generic(material):
    """Newton inherits the material-generic force/HVP: a violent squash
    under the inversion-robust material stays finite and converges."""
    _, obj, s0 = make_2d_object(subdivisions=4, material=material, E=4e5)
    c = np.asarray(s0.pos).mean(axis=0)
    v0 = -(np.asarray(s0.pos) - c) * 20.0
    s = s0.replace(vel=jnp.asarray(v0))
    obs = no_obstacles()
    step = make_substep_fn(
        obj, _cfg(2e-3, g_dir=(0.0, 0.0), integrator="newton")
    )
    for i in range(15):
        s, aux = step(s, obs)
        assert np.isfinite(np.asarray(s.pos)).all(), (material, i)


def test_3d_newton_runs():
    _, obj, s0 = make_3d_object(subdivisions=3)
    s = s0.replace(vel=s0.vel - jnp.asarray([[0.0, 0.8, 0.0]], jnp.float32))
    obs = no_obstacles(3)
    step = make_substep_fn(
        obj, _cfg(1e-3, dim=3, g_dir=(0.0, -1.0, 0.0), integrator="newton")
    )
    for _ in range(10):
        s, _ = step(s, obs)
    assert np.isfinite(np.asarray(s.pos)).all()


def test_diff_rejects_newton():
    from fem_tpu.diff import make_diff_substep_fn

    _, obj, _ = make_2d_object()
    with pytest.raises(ValueError, match="semi_implicit"):
        make_diff_substep_fn(obj, _cfg(5e-4, integrator="newton"))


def test_newton_external_force_matches_semi_in_linear_limit():
    """Neumann loads fold through the same rhs velocity substitution: with a
    tiny dt the two integrators see identical external-force handling."""
    lo, hi = (0.3, 0.55), (0.5, 0.75)
    _, obj, state = make_2d_object(
        subdivisions=4, center=(0.4, 0.65),
        load_boxes=((lo, hi, (0.0, -2.0)),),
    )
    obs = no_obstacles()
    dt = 1e-5
    sa, _ = make_substep_fn(obj, _cfg(dt))(state, obs)
    sb, _ = make_substep_fn(obj, _cfg(dt, integrator="newton"))(state, obs)
    np.testing.assert_allclose(
        np.asarray(sa.vel), np.asarray(sb.vel), rtol=0, atol=1e-6
    )


def test_decoupled_mode_agrees_in_stable_regime():
    """Modified Newton (newton_hessian="decoupled" — each step a
    semi-implicit-shaped solve on the graph operator) must land on the
    same nonlinear root as exact Newton: both drive max|r| below
    newton_tol, so the velocities agree to ~tol."""
    _, obj, state = make_2d_object(subdivisions=5)
    state = state.replace(
        vel=state.vel + jnp.asarray([[0.15, -0.3]], jnp.float32)
    )
    obs = default_obstacles()
    s_ex, aux_ex = make_substep_fn(
        obj, _cfg(5e-4, integrator="newton")
    )(state, obs)
    s_dec, aux_dec = make_substep_fn(
        obj, _cfg(5e-4, integrator="newton", newton_hessian="decoupled")
    )(state, obs)
    diff = np.abs(np.asarray(s_ex.vel) - np.asarray(s_dec.vel)).max()
    assert diff < 3e-5, diff
    assert float(aux_dec.solver_residual) <= (1e-5) ** 2 + 1e-12


def test_decoupled_mode_rescues_kappa_blowup():
    """The decoupled Jacobian is an approximation, but the residual line
    search still guarantees monotone progress — the κ ≈ 60 reproducer must
    stay finite on the fast path too."""
    _, obj, s0 = make_2d_object(subdivisions=7, E=4e5)
    obs = default_obstacles()
    frame_n = make_frame_fn(
        obj, _cfg(2e-3, integrator="newton", newton_hessian="decoupled")
    )
    s = s0
    for i in range(12):
        s, _ = frame_n(s, obs)
        assert np.isfinite(np.asarray(s.pos)).all(), f"NaN at frame {i}"


def test_newton_hessian_validated():
    from fem_tpu.solvers.newton import newton_velocity_solve

    _, obj, state = make_2d_object(subdivisions=3)
    with pytest.raises(ValueError, match="newton_hessian"):
        newton_velocity_solve(obj, state, 5e-4, hessian_mode="bogus")


def test_pcg_inner_solve_matches_plain():
    """cg_precond="block_jacobi" + decoupled Newton: the PCG inner solves
    land on the same nonlinear root as plain-CG inner solves."""
    _, obj, state = make_2d_object(subdivisions=5)
    state = state.replace(
        vel=state.vel + jnp.asarray([[0.15, -0.3]], jnp.float32)
    )
    obs = default_obstacles()
    kw = dict(integrator="newton", newton_hessian="decoupled")
    s_a, _ = make_substep_fn(obj, _cfg(5e-4, **kw))(state, obs)
    s_b, aux_b = make_substep_fn(
        obj, _cfg(5e-4, cg_precond="block_jacobi", **kw)
    )(state, obs)
    diff = np.abs(np.asarray(s_a.vel) - np.asarray(s_b.vel)).max()
    assert diff < 3e-5, diff
    assert float(aux_b.solver_residual) <= (1e-5) ** 2 + 1e-12


def test_pcg_with_exact_mode_rejected():
    from fem_tpu.solvers.newton import newton_velocity_solve

    _, obj, state = make_2d_object(subdivisions=3)
    with pytest.raises(ValueError, match="block_jacobi"):
        newton_velocity_solve(
            obj, state, 5e-4, hessian_mode="exact",
            cg_precond="block_jacobi",
        )


def test_pcg_inner_solve_stable_at_kappa_blowup():
    """Regression for the measured 68k divergence: at κ ≈ 1 the diagonal
    blocks of A are near-singular and an unfloored block-Jacobi inverse
    produces divergent PCG directions (line-search stall → skipped elastic
    solves → explosion).  With the Gershgorin SPD floor
    (solvers/implicit.preconditioned_conjugate_gradient) the κ ≈ 60
    reproducer must stay finite AND bounded under newton + block_jacobi."""
    _, obj, s0 = make_2d_object(subdivisions=7, E=4e5)
    obs = default_obstacles()
    frame = make_frame_fn(
        obj, _cfg(2e-3, integrator="newton", newton_hessian="decoupled",
                  cg_precond="block_jacobi")
    )
    s = s0
    for i in range(12):
        s, _ = frame(s, obs)
        p = np.asarray(s.pos)
        assert np.isfinite(p).all(), f"NaN at frame {i}"
        assert np.abs(p).max() < 10.0, f"exploded at frame {i}"


def test_newton_with_contact_frame():
    """Composition: integrator="newton" inside the multi-body penalty
    contact frame (contact folds pair forces via substep(external_force=…),
    the Newton rhs velocity substitution handles them like the
    semi-implicit path) — the upper body must come to rest ON the lower
    one, both finite."""
    from fem_tpu.contact import make_contact_frame_fn
    from fem_tpu.models.mesh import construct_2d_mesh
    from fem_tpu.models.state import build_object

    objs, states = [], []
    for i, (cx, cy) in enumerate(((0.5, 0.35), (0.5, 0.65))):
        ocfg = ObjectConfig(
            id=i, center=(cx, cy), side_length=0.18, subdivisions=4,
            rho=600.0, E=4e4, nu=0.25, damping=10.0,
        )
        v, f, e = construct_2d_mesh(ocfg)
        obj, state = build_object(ocfg, v, f, e)
        objs.append(obj)
        states.append(state)
    cfg = SimConfig(
        dim=2, delta_time=5e-4, sim_count=10, auto_diff=False,
        use_explicit_method=False, implicit_method=1, preconditioned=0,
        g_dir=(0.0, -1.0), contact="penalty",
        integrator="newton", newton_hessian="decoupled",
    )
    frame = make_contact_frame_fn(objs, cfg)
    obs = no_obstacles()
    for _ in range(30):
        states, _ = frame(states, obs)
    pa, pb = np.asarray(states[0].pos), np.asarray(states[1].pos)
    assert np.isfinite(pa).all() and np.isfinite(pb).all()
    # Upper body rests above the lower one (no pass-through).
    assert pb[:, 1].min() > pa[:, 1].mean() - 0.02


def test_newton_composes_with_adaptive_dt():
    """adaptive_dt + newton: the guard wraps the Newton substep; benign κ
    runs one inner step bit-identical to the unguarded Newton substep."""
    _, obj, state = make_2d_object(subdivisions=5)
    state = state.replace(
        vel=state.vel + jnp.asarray([[0.1, -0.2]], jnp.float32)
    )
    obs = default_obstacles()
    kw = dict(integrator="newton", newton_hessian="decoupled")
    s_plain, _ = make_substep_fn(obj, _cfg(5e-4, **kw))(state, obs)
    s_guard, _ = make_substep_fn(
        obj, _cfg(5e-4, adaptive_dt=True, **kw)
    )(state, obs)
    np.testing.assert_array_equal(
        np.asarray(s_guard.pos), np.asarray(s_plain.pos)
    )
