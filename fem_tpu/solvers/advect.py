# coding=utf-8
"""Advection + collision handling (explicit and implicit variants).

Vectorized, fused equivalents of the reference's per-particle kernels:

  * ``kinematic`` / ``kinematic_particle``: solver/kinematic.py:8-45
  * ``advect_implicit``:                    solver/implicit.py:407-438

Quirks reproduced exactly:
  * the box walls are *sticky* per-component velocity zeroing, applied in the
    order lower-wall then upper-wall (kinematic.py:25-30);
  * the implicit upper-wall case zeroes ``vel`` but **not** ``vel_g``
    (commented out in the reference at implicit.py:422);
  * circle obstacles are processed sequentially, each seeing the velocity
    already modified by the previous one (kinematic.py:32-41);
  * gravity is 9.8·g_dir with g_dir straight from config;
  * damping is the exponential factor exp(−dt·damping).
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from fem_tpu.models.state import Obstacles, SimState


def _sticky_walls(
    pos: jnp.ndarray, v: jnp.ndarray, wall_friction: float = 0.0
) -> jnp.ndarray:
    """Zero velocity components pushing through the unit box walls
    (kinematic.py:25-30).  ``wall_friction`` > 0 (extension,
    SimConfig.wall_friction) adds an impulse-level Coulomb cone: the
    zeroed components removed the normal speed j_n = Σ|v_k|, so the
    remaining (tangential) components scale by
    s = max(0, 1 − μ·j_n/|v_t|).  μ = 0 compiles to the reference walls."""
    hit = ((pos < 0.0) & (v < 0.0)) | ((pos > 1.0) & (v > 0.0))
    v_t = jnp.where(hit, 0.0, v)
    if wall_friction > 0.0:
        jn = jnp.sum(jnp.abs(v) * hit, axis=-1, keepdims=True)
        t_speed = jnp.sqrt(jnp.sum(v_t * v_t, axis=-1, keepdims=True))
        s = jnp.maximum(
            0.0, 1.0 - wall_friction * jn / jnp.maximum(t_speed, 1e-20)
        )
        v_t = jnp.where(jn > 0.0, s * v_t, v_t)
    return v_t


def _circle_projection(
    pos: jnp.ndarray, v: jnp.ndarray, center: jnp.ndarray, radius: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Hit mask and the tangential-projection delta for one circular block
    (kinematic.py:36-41): inside the circle and moving toward its center →
    remove the radial velocity component."""
    disp = pos - center[None, :]  # (N, d)
    dist_sq = jnp.sum(disp * disp, axis=-1, keepdims=True)
    inside = dist_sq < radius * radius
    toward = jnp.sum(v * (-disp), axis=-1, keepdims=True) > 0.0
    hit = inside & toward & (radius > 0.0)
    coeff = jnp.sum(v * disp, axis=-1, keepdims=True) / jnp.maximum(
        dist_sq, 1e-30
    )
    return hit, coeff * disp


def kinematic_step(
    state: SimState,
    grad: jnp.ndarray,
    mass: jnp.ndarray,
    obstacles: Obstacles,
    dt: float,
    damping: float,
    g_dir: Tuple[float, ...],
    free_mask: jnp.ndarray | None = None,
    pin_vel: jnp.ndarray | None = None,
    wall_friction: float = 0.0,
) -> SimState:
    """Explicit-path advection (kinematic.py:14-45).

    ``grad`` is the assembled energy gradient (the reference's
    ``particles.force`` / ``pos.grad``), subtracted as −grad/m.
    ``free_mask`` (N, 1) zeroes pinned vertices'
    velocity before the position update (Dirichlet extension); ``pin_vel``
    (N, d) overrides pinned vertices with a prescribed velocity instead
    (kinematic loading — bypasses damping/walls/obstacles by construction).
    """
    from fem_tpu.obstacles import apply_extensions_explicit, has_extensions

    g = 9.8 * jnp.asarray(g_dir, jnp.float32)
    vel = state.vel + (g[None, :] - grad / mass[:, None]) * dt
    vel = vel * jnp.exp(-dt * damping)
    vel = _sticky_walls(state.pos, vel, wall_friction)
    n_blocks = int(obstacles.radii.shape[0])
    for b in range(n_blocks):  # static unroll; blocks are few and sequential
        hit, delta = _circle_projection(
            state.pos, vel, obstacles.centers[b], obstacles.radii[b]
        )
        vel = jnp.where(hit, vel - delta, vel)
    if has_extensions(obstacles):
        # SDF obstacle extensions (fem_tpu/obstacles.py): halfspaces, solid
        # boxes, mesh SDFs — same slide semantics, applied after the
        # reference circles in the same sequential fashion.
        vel = apply_extensions_explicit(state.pos, vel, obstacles)
    if free_mask is not None:
        vel = vel * free_mask
        if pin_vel is not None:
            vel = vel + pin_vel
    pos = state.pos + vel * dt
    return state.replace(pos=pos, vel=vel, force=jnp.zeros_like(grad))


def advect_implicit_step(
    state: SimState,
    obstacles: Obstacles,
    dt: float,
    damping: float,
    g_dir: Tuple[float, ...],
    free_mask: jnp.ndarray | None = None,
    pin_vel: jnp.ndarray | None = None,
    wall_friction: float = 0.0,
    theta: float = 1.0,
    vel_pos_old: jnp.ndarray | None = None,
) -> SimState:
    """Implicit-path advection (implicit.py:407-438): gravity lives in the
    separate ``vel_g`` channel outside the linear solve.  ``free_mask``
    (N, 1) zeroes pinned vertices' velocity channels before the position
    update (Dirichlet extension); ``pin_vel`` (N, d) overrides pinned
    vertices with a prescribed velocity (kinematic loading).

    ``theta`` < 1 (generalized-trapezoidal extension, SimConfig.newton_theta
    — θ = 1/2 is the implicit midpoint rule) moves positions by the
    θ-weighted velocity dt·((1−θ)·v_old + θ·v) where ``vel_pos_old`` is the
    start-of-substep combined velocity (vel + vel_g before the elastic
    solve) and v the post-collision end-of-substep velocity — consistent
    with the Newton solve's force evaluation at x(v); the stored velocity
    channels stay the end-of-substep values.  θ = 1 compiles to the
    reference's pos += v·dt exactly."""
    from fem_tpu.obstacles import apply_extensions_implicit, has_extensions

    g = 9.8 * jnp.asarray(g_dir, jnp.float32)
    vel_g = state.vel_g + g[None, :] * dt
    decay = jnp.exp(-dt * damping)
    vel = state.vel * decay
    vel_g = vel_g * decay
    v = vel + vel_g

    v_pre = v
    lower = (state.pos < 0.0) & (v < 0.0)
    vel = jnp.where(lower, 0.0, vel)
    vel_g = jnp.where(lower, 0.0, vel_g)
    v = jnp.where(lower, 0.0, v)

    upper = (state.pos > 1.0) & (v > 0.0)
    vel = jnp.where(upper, 0.0, vel)
    # Reference deliberately does NOT zero vel_g here (implicit.py:422).
    v = jnp.where(upper, 0.0, v)

    if wall_friction > 0.0:
        # Wall Coulomb friction (extension, SimConfig.wall_friction): the
        # zeroing removed normal speed j_n from the combined velocity;
        # scale the tangential (non-hit) components of BOTH channels by
        # s = max(0, 1 − μ·j_n/|v_t|).  Hit components keep their
        # post-zeroing values (including the vel_g upper-wall quirk).
        hit = lower | upper
        jn = jnp.sum(jnp.abs(v_pre) * hit, axis=-1, keepdims=True)
        t_speed = jnp.sqrt(jnp.sum(v * v, axis=-1, keepdims=True))
        s = jnp.maximum(
            0.0, 1.0 - wall_friction * jn / jnp.maximum(t_speed, 1e-20)
        )
        scale = jnp.where(jn > 0.0, s, 1.0)
        vel = jnp.where(hit, vel, scale * vel)
        vel_g = jnp.where(hit, vel_g, scale * vel_g)
        v = jnp.where(hit, v, scale * v)

    n_blocks = int(obstacles.radii.shape[0])
    for b in range(n_blocks):
        center, radius = obstacles.centers[b], obstacles.radii[b]
        hit, delta_v = _circle_projection(state.pos, v, center, radius)
        disp = state.pos - center[None, :]
        dist_sq = jnp.sum(disp * disp, axis=-1, keepdims=True)
        proj = lambda u: (
            jnp.sum(u * disp, axis=-1, keepdims=True)
            / jnp.maximum(dist_sq, 1e-30)
        ) * disp
        v = jnp.where(hit, v - delta_v, v)
        vel = jnp.where(hit, vel - proj(vel), vel)
        vel_g = jnp.where(hit, vel_g - proj(vel_g), vel_g)

    if has_extensions(obstacles):
        # SDF obstacle extensions — hit test on the combined v, both
        # channels projected (the reference's implicit circle structure).
        v, vel, vel_g = apply_extensions_implicit(
            state.pos, v, vel, vel_g, obstacles
        )

    if free_mask is not None:
        vel = vel * free_mask
        vel_g = vel_g * free_mask
        v = v * free_mask
        if pin_vel is not None:
            vel = vel + pin_vel
            v = v + pin_vel
    if theta == 1.0:
        pos = state.pos + v * dt
    else:
        # θ-weighting only on components collisions did not touch
        # (ADVICE r4 #2): a component zeroed/projected by a wall or
        # obstacle this substep would still advance by
        # (1−θ)·vel_pos_old·dt of its PRE-collision velocity — penetrating
        # up to half a substep's travel deeper than the θ=1 reference
        # semantics.  Collision-modified components (v differs from the
        # pre-collision combined velocity v_pre; pins/friction scaling
        # included) fall back to the pure end-of-substep velocity there.
        touched = v != v_pre
        v_theta = (1.0 - theta) * vel_pos_old + theta * v
        pos = state.pos + jnp.where(touched, v, v_theta) * dt
    return state.replace(pos=pos, vel=vel, vel_g=vel_g)
