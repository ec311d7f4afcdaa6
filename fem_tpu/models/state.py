# coding=utf-8
"""State containers: pytrees of arrays + static scalars.

The reference holds all state in Taichi struct fields on one ``Object``
(object.py:12-93) mutated in place by kernels.  Here simulation
state is an immutable pytree (:class:`SimState`) threaded through pure jitted
step functions; the static mesh/material data lives in :class:`FemObject`.
Scalars that must be trace-time constants (dim, counts, material params) are
static fields (fem_tpu/utils/pytree.py).
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
import numpy as np

from fem_tpu.utils.config import BlockConfig, ObjectConfig
from fem_tpu.utils.pytree import dataclass, static_field


@dataclass
class SimState:
    """Per-particle dynamic state (reference: ``Particle`` struct members that
    are actually live — object.py:12-23 minus the dead vel_next/implicit_A/b;
    ``acc`` is read-but-never-written in the reference so it is dropped)."""

    pos: jnp.ndarray  # (N, d)
    vel: jnp.ndarray  # (N, d)
    vel_g: jnp.ndarray  # (N, d) implicit-path gravity velocity (implicit.py:409)
    force: jnp.ndarray  # (N, d) energy gradient accumulator (explicit.py:46)
    # Weighted-Jacobi relaxation anchor, persisted across steps exactly like the
    # reference's never-reset ``past_vec_x`` field (object.py:85; used at
    # solver/implicit.py:404 before any cache_x of the current step).
    jacobi_past_x: jnp.ndarray  # (N, d)
    # Per-element internal variables of the inelastic material extensions
    # (fem_tpu/ops/inelastic.py; None under pure reference configs):
    # plastic_inv = F_p⁻¹ (multiplicative von-Mises plasticity, elastic part
    # F_e = F·F_p⁻¹), viscous_inv = F_v⁻¹ (generalized-Maxwell branch strain
    # F·F_v⁻¹, relaxing with time constant viscous_tau).  Both (E, d, d),
    # initialized to identity.
    plastic_inv: jnp.ndarray = None
    viscous_inv: jnp.ndarray = None


@dataclass
class FemObject:
    """Static per-object data: mesh topology, reference config, material."""

    # --- arrays (pytree leaves) ---
    element_indices: jnp.ndarray  # (E, d+1) int32
    ref_inv: jnp.ndarray  # (E, d, d)  inverse rest-edge matrices (object.py:362)
    volume: jnp.ndarray  # (E,)       rest volumes (object.py:356)
    mass: jnp.ndarray  # (N,)         lumped masses (object.py:358-360)
    rest_pos: jnp.ndarray  # (N, d)   ref_pos (object.py:342)
    faces: jnp.ndarray  # (M, 3) int32 render/surface faces
    # Per-particle incidence plan (N, cap) for gather-based assembly
    # (ops/assembly.py:build_gather_plan): deterministic sums, no atomics.
    # Two-tier when the valence distribution is skewed (split_two_tier):
    # gather_hi (N2, maxdeg-cap) holds the outlier particles' (gather_out)
    # remaining rows, index-added on top; both None on small/uniform meshes.
    gather_idx: jnp.ndarray = None
    gather_hi: jnp.ndarray = None
    gather_out: jnp.ndarray = None
    # Dense ±1 edge-difference operator S (E·d, N) for the "mxu" operator mode
    # (solvers/implicit.py:build_edge_matrix); attached at build time for
    # small meshes, None otherwise.
    edge_matrix: jnp.ndarray = None
    # Block-sparse row plan for the serial Gauss–Seidel-style Jacobi sweep
    # (ops/assembly.py::build_jacobi_plan): per-particle neighbor slots +
    # per-element contribution scatter — lets the parity sweep run O(E)
    # instead of materializing the reference's dense (N·d, N·d) system.
    jacobi_nb: jnp.ndarray = None  # (N, max_nb) int32
    jacobi_slots: jnp.ndarray = None  # (E, 4d) int32 flat (N·max_nb) indices
    jacobi_coeff: jnp.ndarray = None  # (E, 4d) float32 ±1
    # Dirichlet mask (extension, ObjectConfig.pin_boxes): (N, 1) float32 with
    # 1.0 on free vertices and 0.0 on pinned ones.  None = no constraints
    # (reference behavior).  Pinned vertices are kinematic: zero velocity,
    # held position; the implicit solve projects them out (P·A·P + I−P).
    free_mask: jnp.ndarray = None
    # Prescribed pin velocity (extension, 3-element pin_boxes entries):
    # (N, d) float32, zero on free and statically-pinned vertices, the
    # prescribed constant velocity on moving pins.  None when no pin moves.
    pin_vel: jnp.ndarray = None
    # Neumann loads (extension, ObjectConfig.load_boxes): (N, d) float32
    # per-vertex static force, or None when no loads are configured.
    # Folded into every substep as an external force and into solve_static.
    static_load: jnp.ndarray = None
    # Two-level preconditioner coarse space (extension, solvers/multilevel):
    # Morton particle aggregates + per-particle rigid-body basis rows,
    # built host-side at load.  None only for hand-built FemObjects.
    agg_ids: jnp.ndarray = None  # (N,) int32
    agg_basis: jnp.ndarray = None  # (N, d, n_rb) float32
    # --- static metadata ---
    # "gather" (default, single-chip) or "segment" (used under shard_map
    # where each shard owns an element slice and psum-reduces).
    assembly_mode: str = static_field("gather")
    dim: int = static_field(2)
    particle_cnt: int = static_field(0)
    element_cnt: int = static_field(0)
    mesh_cnt: int = static_field(0)
    mu: float = static_field(0.0)
    s_lambda: float = static_field(0.0)
    damping: float = static_field(0.0)
    # Stiffness-proportional Rayleigh damping β (ObjectConfig.damping_beta,
    # extension): damping force β·G(K)·v on the decoupled block Hessian.
    # 0.0 = reference parity.
    damping_beta: float = static_field(0.0)
    # Inelastic material extensions (ObjectConfig.plastic_yield /
    # viscous_mu / viscous_tau; fem_tpu/ops/inelastic.py).  0.0 = off.
    plastic_yield: float = static_field(0.0)
    viscous_mu: float = static_field(0.0)
    viscous_tau: float = static_field(0.1)
    num_aggregates: int = static_field(0)
    rho: float = static_field(0.0)
    material: str = static_field("neo_hookean")


@dataclass
class Obstacles:
    """Circular obstacle set (reference: circle_blocks.py:6-25).  Zero-radius
    blocks are skipped by the collision predicate (kinematic.py:34-35), so
    padding with radius 0 is free.

    Extension fields (SimConfig.obstacles / fem_tpu/obstacles.py — all None
    under pure reference configs): typed SDF obstacles with the reference's
    slide-collision semantics.  ``sphere`` entries are folded straight into
    ``centers``/``radii`` (the circle math is dimension-generic)."""

    centers: jnp.ndarray  # (B, d)
    radii: jnp.ndarray  # (B,)
    half_p: jnp.ndarray = None  # (H, d) half-space anchor points
    half_n: jnp.ndarray = None  # (H, d) outward unit normals
    box_lo: jnp.ndarray = None  # (Bx, d) solid-box corners
    box_hi: jnp.ndarray = None  # (Bx, d)
    sdf_grid: jnp.ndarray = None  # (M, nx, ny, nz) mesh SDF grids
    sdf_origin: jnp.ndarray = None  # (M, 3)
    sdf_spacing: jnp.ndarray = None  # (M,)
    # Frictional spheres (extension): spheres whose config carries a
    # Coulomb coefficient live here instead of the reference circle arrays
    # (same slide math, plus the tangential Coulomb reduction).
    sph_c: jnp.ndarray = None  # (S, d)
    sph_r: jnp.ndarray = None  # (S,)
    # Per-obstacle Coulomb coefficients μ (static: config constants — the
    # zero-friction case compiles to the exact reference slide).
    half_f: Tuple[float, ...] = static_field(())
    box_f: Tuple[float, ...] = static_field(())
    sdf_f: Tuple[float, ...] = static_field(())
    sph_f: Tuple[float, ...] = static_field(())

    @staticmethod
    def from_configs(
        blocks: Tuple[BlockConfig, ...], dim: int, obstacle_cfgs=(),
    ) -> "Obstacles":
        centers_l = [b.block_center for b in blocks]
        radii_l = [b.block_radius for b in blocks]
        fields = {}
        if obstacle_cfgs:
            from fem_tpu.obstacles import build_extension_arrays

            fields, spheres = build_extension_arrays(obstacle_cfgs, dim)
            for c, r in spheres:
                centers_l.append(c)
                radii_l.append(r)
        if not centers_l:
            centers_l, radii_l = [np.zeros((dim,), np.float32)], [0.0]
        return Obstacles(
            centers=jnp.asarray(np.array(centers_l, np.float32)),
            radii=jnp.asarray(np.array(radii_l, np.float32)),
            **fields,
        )


def init_element_data(
    vertices: np.ndarray, element_indices: np.ndarray, rho: float
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side element initialization (reference: ``elements_init`` kernel,
    object.py:346-362): rest edge matrices r (columns ``p_i − p_0``), volumes
    (2D: |cross|/2, 3D: |det|/6 — object.py:377-392), lumped vertex masses
    ``V·ρ/(d+1)`` and ``ref = r⁻¹``.

    Returns (ref_inv (E,d,d), volume (E,), mass (N,)) as float32 numpy.
    """
    v = vertices.astype(np.float64)
    idx = element_indices.astype(np.int64)
    d = v.shape[1]
    p = v[idx]  # (E, d+1, d)
    r = np.swapaxes(p[:, 1:, :] - p[:, 0:1, :], -1, -2)  # (E, d, d) columns = edges
    if d == 2:
        vol = 0.5 * np.abs(r[:, 0, 0] * r[:, 1, 1] - r[:, 1, 0] * r[:, 0, 1])
    else:
        vol = np.abs(np.linalg.det(r)) / 6.0
    mass = np.zeros(v.shape[0])
    np.add.at(mass, idx.reshape(-1), np.repeat(vol / (d + 1) * rho, d + 1))
    ref_inv = np.linalg.inv(r)
    return (
        ref_inv.astype(np.float32),
        vol.astype(np.float32),
        mass.astype(np.float32),
    )


def build_object(
    cfg: ObjectConfig,
    vertices: np.ndarray,
    faces: np.ndarray,
    element_indices: np.ndarray,
    operator_mode: str = "auto",
) -> Tuple[FemObject, SimState]:
    """Assemble a :class:`FemObject` + initial :class:`SimState` from mesh
    arrays (reference: Object.__init__ + particles_init, object.py:44-93,
    337-343: ``pos = vertices + center``).

    ``operator_mode`` mirrors ``SimConfig.operator_mode``: the dense edge
    matrix (O(E·d·N) device memory) is built only when ``"mxu"`` is
    explicitly forced (fem_tpu/strategy.py)."""
    from fem_tpu.ops.assembly import build_gather_plan, split_two_tier
    from fem_tpu.solvers.implicit import build_edge_matrix

    d = vertices.shape[1]
    pos = vertices.astype(np.float32) + np.asarray(cfg.center, np.float32)
    ref_inv, volume, mass = init_element_data(pos, element_indices, cfg.rho)
    n = pos.shape[0]
    free_mask = None
    pin_boxes = getattr(cfg, "pin_boxes", ())
    pin_vel = None
    if pin_boxes:
        pinned = np.zeros((n,), bool)
        pin_vel_np = np.zeros((n, d), np.float32)
        any_moving = False
        for box in pin_boxes:
            lo_a = np.asarray(box[0], np.float32)
            hi_a = np.asarray(box[1], np.float32)
            sel = np.all((pos >= lo_a) & (pos <= hi_a), axis=1)
            pinned |= sel
            if len(box) > 2:  # prescribed-velocity pin (kinematic loading)
                pin_vel_np[sel] = np.asarray(box[2], np.float32)
                any_moving = True
        free_mask = jnp.asarray((~pinned).astype(np.float32)[:, None])
        if any_moving:
            pin_vel = jnp.asarray(pin_vel_np)
    static_load = None
    load_boxes = getattr(cfg, "load_boxes", ())
    if load_boxes:
        load = np.zeros((n, d), np.float32)
        for lo, hi, f_total in load_boxes:
            lo_a = np.asarray(lo, np.float32)
            hi_a = np.asarray(hi, np.float32)
            sel = np.all((pos >= lo_a) & (pos <= hi_a), axis=1)
            if not sel.any():
                raise ValueError(
                    f"load_boxes: box ({lo}, {hi}) selects no vertices"
                )
            # Mass-weighted distribution of the TOTAL force: refinement-
            # independent (a body force over the selected region).
            w = mass * sel
            w = w / w.sum()
            load += w[:, None] * np.asarray(f_total, np.float32)[None, :]
        static_load = jnp.asarray(load)
    from fem_tpu.ops.assembly import build_jacobi_plan
    from fem_tpu.strategy import builds_edge_matrix

    jac_nb, jac_slots, jac_coeff = build_jacobi_plan(element_indices, n)
    # Two-tier assembly plan (ops/assembly.split_two_tier): vertex valence
    # on tet meshes is skewed, so the (N, maxdeg) plan is mostly sentinel
    # padding; small/uniform meshes keep the single tier bit-identically.
    plan = build_gather_plan(element_indices, n)
    valence = np.bincount(
        np.asarray(element_indices).reshape(-1), minlength=n
    )
    g_lo, g_hi, g_out = split_two_tier(plan, valence)
    # Two-level preconditioner coarse space (solvers/multilevel.py): Morton
    # aggregates + rigid-body basis, O(N) host work at load.
    from fem_tpu.solvers.multilevel import (
        build_aggregates, default_aggregate_size,
    )

    agg_ids_np, agg_basis_np = build_aggregates(
        pos, default_aggregate_size(d)
    )
    obj = FemObject(
        element_indices=jnp.asarray(element_indices.astype(np.int32)),
        ref_inv=jnp.asarray(ref_inv),
        volume=jnp.asarray(volume),
        mass=jnp.asarray(mass),
        rest_pos=jnp.asarray(pos),
        faces=jnp.asarray(faces.astype(np.int32)),
        gather_idx=jnp.asarray(g_lo),
        gather_hi=None if g_hi is None else jnp.asarray(g_hi),
        gather_out=None if g_out is None else jnp.asarray(g_out),
        edge_matrix=(
            jnp.asarray(build_edge_matrix(element_indices, n))
            if builds_edge_matrix(operator_mode, element_indices.shape[0], n, d)
            else None
        ),
        jacobi_nb=jnp.asarray(jac_nb),
        jacobi_slots=jnp.asarray(jac_slots),
        jacobi_coeff=jnp.asarray(jac_coeff),
        free_mask=free_mask,
        pin_vel=pin_vel,
        static_load=static_load,
        agg_ids=jnp.asarray(agg_ids_np),
        agg_basis=jnp.asarray(agg_basis_np),
        num_aggregates=int(agg_ids_np.max()) + 1,
        dim=d,
        particle_cnt=n,
        element_cnt=int(element_indices.shape[0]),
        mesh_cnt=int(faces.shape[0]),
        mu=cfg.mu,
        s_lambda=cfg.s_lambda,
        damping=cfg.damping,
        damping_beta=getattr(cfg, "damping_beta", 0.0),
        plastic_yield=getattr(cfg, "plastic_yield", 0.0),
        viscous_mu=getattr(cfg, "viscous_mu", 0.0),
        viscous_tau=getattr(cfg, "viscous_tau", 0.1),
        rho=cfg.rho,
        material=getattr(cfg, "material", "neo_hookean"),
    )
    zeros = jnp.zeros((n, d), jnp.float32)
    e_cnt = int(element_indices.shape[0])
    eye_e = jnp.broadcast_to(
        jnp.eye(d, dtype=jnp.float32), (e_cnt, d, d)
    )
    state = SimState(
        pos=jnp.asarray(pos), vel=zeros, vel_g=zeros, force=zeros,
        jacobi_past_x=zeros,
        plastic_inv=eye_e if obj.plastic_yield > 0.0 else None,
        viscous_inv=eye_e if obj.viscous_mu > 0.0 else None,
    )
    return obj, state


def dense_system_matrix(
    obj: FemObject, state: SimState, dt: float
) -> np.ndarray:
    """Densely assemble the reference implicit matrix A (N·d, N·d) for
    validation — mirrors solver/implicit.py:114-194 exactly.  Test-only
    (O(N²) memory), used to cross-check the matrix-free apply."""
    from fem_tpu.ops.element import hessian_blocks  # local to avoid cycle

    d, n = obj.dim, obj.particle_cnt
    K = np.asarray(
        hessian_blocks(
            state.pos, obj.element_indices, obj.ref_inv, obj.volume,
            obj.mu, obj.s_lambda,
        )
    )
    idx = np.asarray(obj.element_indices)
    A = np.zeros((n, n, d, d), np.float64)
    for e in range(idx.shape[0]):
        v0 = idx[e, 0]
        for i in range(1, d + 1):
            vi = idx[e, i]
            A[vi, vi] += K[e]
            A[vi, v0] -= K[e]
            A[v0, vi] -= K[e]
            A[v0, v0] += K[e]
    mass = np.asarray(obj.mass)
    A = (dt ** 2) * A / mass[:, None, None, None]
    A = -A
    A[np.arange(n), np.arange(n)] += np.eye(d)
    return A.transpose(0, 2, 1, 3).reshape(n * d, n * d)
