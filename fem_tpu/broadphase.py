# coding=utf-8
"""Uniform-grid broad phase for penalty contact at scale.

The dense pair machinery in fem_tpu/contact.py materializes (ns_a, ns_b)
coefficient matrices — one matrix product per body pair, unbeatable for
the multi-body demo scales but O(ns²) in device memory: ~270 MB of
transients at an
8k-vertex surface and out of reach at the 212k-tet scale (~20k surface
vertices → 1.6 GB per matrix).  This module is the scaling path: a
uniform grid with cell size = contact radius, rebuilt every substep from
scratch (positions move), in static shapes throughout — the static-shape
substitute for pointer-chasing neighbor lists:

1. quantize positions to grid cells, encode to one int32 cell id;
2. ``argsort`` the ids (XLA sort — no scatter into per-cell buckets);
3. FORWARD-ONLY (half) stencil: every unordered pair within the radius
   either shares a cell or differs by an offset in {-1,0,1}^d, and
   exactly one of ±offset has a positive linearized id delta — so each
   vertex scans (a) the next ``cap`` slots of its OWN cell in sorted
   order and (b) ``cap`` slots at the ``searchsorted`` start of each of
   the (3^d−1)/2 lexicographically-forward neighbor cells.  Every pair
   is found at most ONCE; candidate volume is (ns, (3^d+1)/2·cap) —
   half the naive both-sides stencil.  The win is halved candidate
   memory plus cleaner semantics: truncation drops a pair entirely
   instead of halving its force;
4. elementwise penalty (same formulas as contact._pair_coefs: coefficient
   k·max(0, r−d)/max(d, 0.1r), viscous dashpot on the overlap ramp) over
   the candidate set, each found pair scattered to BOTH endpoints
   (+f to i, −f to j) — Newton's third law holds exactly per found
   pair, so momentum is conserved even when a full cell truncates a
   candidate list.

Same-body pairs are admitted only when the REST distance exceeds the
exclusion radius (the dense path's precomputed (ns, ns) rest mask, here
evaluated per candidate on the fly — no quadratic storage).  Bodies are
concatenated into one vertex soup with a per-vertex body id, so ONE grid
pass covers every body pair AND self-contact.

Cost: O(ns·(3^d+1)/2·cap) work and memory per substep.  Truncation: a
cell holds at most ~(r/h+1)^d surface vertices (h = surface spacing ≈ r
by the auto-radius rule), so cap 8 is generous for simple contact and
cap can be raised for crushed configurations; truncated pairs drop
(softening the penalty) but never break momentum.

WHEN TO USE: the dense path's O(ns²) pair matrices are plain matrix
products and win while they fit in device memory (a 98k-vertex pair
matrix is 9 GiB); which path is faster below that on a GPU has not been
measured (tools/probe_broadphase.py compares them).  The grid is the
path for (a) scenes past the dense memory wall (~1 GiB per pair
tensor with ``contact_mu``, which needs explicit (ns_a, ns_b, d) pair
tensors on the dense side) and (b) many-body scenes (dense unrolls
O(B²) pair matmuls at trace time).  ``contact_broadphase="auto"``
encodes exactly that rule.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

_HP = jax.lax.Precision.HIGHEST


def grid_shape(radius: float, dim: int) -> Tuple[int, int]:
    """(cells per axis M, id stride base) for cell size = radius over the
    unit domain with one margin cell each side (positions may leave [0,1]
    transiently; coordinates clamp into the margin)."""
    m = int(np.ceil(1.0 / radius)) + 2
    if m ** dim >= 2 ** 31:
        raise ValueError(
            f"contact radius {radius:g} too small for the int32 grid "
            f"({m}^{dim} cells); raise contact_radius or use the dense path"
        )
    return m, m


def grid_contact_forces(
    pos: jnp.ndarray,  # (ns, d) concatenated participating vertices
    body_id: jnp.ndarray,  # (ns,) int32
    rest_pos: jnp.ndarray,  # (ns, d) rest positions (same-body exclusion)
    radius: float,
    stiffness: float,
    vel: Optional[jnp.ndarray] = None,
    friction_c: float = 0.0,
    cap: int = 8,
    self_contact: bool = False,
    excl_radius: Optional[float] = None,
    mu: float = 0.0,
    mu_slope: float = 0.0,
) -> jnp.ndarray:
    """Penalty contact forces over the vertex soup via the uniform grid.

    Pair admission: different ``body_id`` always; same body only when
    ``self_contact`` and rest distance > ``excl_radius`` (default
    2.5·radius — matching contact.build_contact_plan's dense mask).
    Each admitted pair is found at most once (forward-only stencil) and
    scatters the full ±f to both endpoints.  Returns (ns, d) forces in
    the input order.

    ``mu`` > 0 adds regularized Coulomb pair friction (same semantics as
    contact._pair_mu_forces, the dense explicit-tensor variant — forces
    agree to f32 rounding where no cell overflows the cap): per active
    pair the TANGENTIAL relative
    velocity v_t (normal component projected out) is opposed by
    f_t = −min(mu_slope·|v_t|, μ·|f_n|)·v̂_t with |f_n| = k·pen the pair's
    normal penalty magnitude — a tangential dashpot capped by the Coulomb
    cone (slope ``mu_slope``, typically √(k·m_min) = pair critical
    damping).  Inside the cone contacts creep viscously instead of
    locking (the standard penalty regularization); at the cap a sliding
    body under weight W decelerates at μ·W/m.  Antisymmetric per pair ⇒
    momentum-conserving.  Composes with the isotropic ``friction_c``
    dashpot (which damps normal approach too)."""
    ns, d = pos.shape
    m, _ = grid_shape(radius, d)
    inv = 1.0 / radius
    excl = 2.5 * radius if excl_radius is None else excl_radius

    ic = jnp.clip(
        jnp.floor(pos * inv).astype(jnp.int32) + 1, 0, m - 1
    )  # (ns, d) margin-shifted cell coords
    strides = jnp.asarray(
        [m ** k for k in range(d - 1, -1, -1)], jnp.int32
    )
    cell = jnp.sum(ic * strides[None, :], axis=1)  # (ns,)

    order = jnp.argsort(cell)
    cell_s = cell[order]
    # PACKED candidate rows: every per-vertex field goes into ONE (ns, K)
    # row matrix in sorted order and is gathered once, instead of four
    # separate (ns, q, d)-row gathers; columns slice out in registers.
    # body ids ride as f32 (exact for < 2^24 vertices).
    parts = [pos[order]]
    col_vel = None
    if vel is not None:
        col_vel = d
        parts.append(vel[order])
    col_rest = None
    if self_contact:
        col_rest = sum(p.shape[1] for p in parts)
        parts.append(rest_pos[order])
    col_body = sum(p.shape[1] for p in parts)
    parts.append(body_id[order].astype(jnp.float32)[:, None])
    packed = jnp.concatenate(parts, axis=1)  # (ns, K)
    pos_s = packed[:, :d]
    vel_s = None if col_vel is None else packed[:, col_vel:col_vel + d]
    body_s = packed[:, col_body]

    # Forward-only stencil: the (3^d−1)/2 neighbor offsets whose
    # LINEARIZED id delta is positive (lexicographic ≻ 0; for m ≥ 3 the
    # strided sum dx·m^{d-1}+… is positive iff (dx, …) ≻ 0, no carry
    # ambiguity).  The ±offset pair splits exactly one each way, so with
    # the same-cell forward scan below every unordered pair in adjacent
    # cells is enumerated at most once.
    all_offs = np.array(
        np.meshgrid(*([[-1, 0, 1]] * d), indexing="ij")
    ).reshape(d, -1).T @ np.array(
        [int(m ** k) for k in range(d - 1, -1, -1)]
    )
    offs = jnp.asarray(all_offs[all_offs > 0], jnp.int32)  # ((3^d−1)/2,)
    nbr = cell_s[:, None] + offs[None, :]  # (ns, n_off)

    slot = jnp.arange(cap, dtype=jnp.int32)
    i_row = jnp.arange(ns, dtype=jnp.int32)[:, None]
    # Same cell: the next `cap` slots in sorted order (rank i finds rank
    # j > i — each same-cell pair once).
    idx_own = i_row + 1 + slot[None, :]  # (ns, cap)
    nbr_own = cell_s[:, None]
    # Forward cells: `cap` slots from each searchsorted start.
    start = jnp.searchsorted(cell_s, nbr.reshape(-1)).reshape(
        ns, -1
    )  # (ns, n_off)
    idx_fwd = start[:, :, None] + slot[None, None, :]  # (ns, n_off, cap)
    idx = jnp.concatenate(
        [idx_own[:, None, :], idx_fwd], axis=1
    )  # (ns, n_off+1, cap)
    tgt = jnp.concatenate([nbr_own, nbr], axis=1)  # (ns, n_off+1)
    idx_c = jnp.minimum(idx, ns - 1)
    valid = (idx < ns) & (cell_s[idx_c] == tgt[:, :, None])
    j = idx_c.reshape(ns, -1)  # (ns, q) candidate sorted-positions
    valid = valid.reshape(ns, -1)

    cand = packed[j]  # ONE (ns, q, K) row gather for every candidate field
    same_body = cand[..., col_body] == body_s[:, None]
    if self_contact:
        rd = cand[..., col_rest:col_rest + d] - packed[
            :, None, col_rest:col_rest + d
        ]  # (ns, q, d)
        rest_ok = jnp.sum(rd * rd, axis=-1) > excl * excl
        admit = jnp.where(same_body, rest_ok, True)
    else:
        admit = ~same_body
    valid = valid & admit

    diff = pos_s[:, None, :] - cand[..., :d]  # (ns, q, d)
    d2 = jnp.sum(diff * diff, axis=-1)
    dist = jnp.sqrt(jnp.maximum(d2, 1e-18))
    pen = jnp.maximum(radius - dist, 0.0)
    coef = stiffness * pen / jnp.maximum(dist, 0.1 * radius)
    coef = jnp.where(valid, coef, 0.0)
    # Each unordered pair is found at most once (forward stencil): the
    # full force scatters +f to the finder i and −f to the candidate j.
    f_pair = coef[..., None] * diff  # (ns, q, d)
    if vel is not None and (friction_c > 0.0 or mu > 0.0):
        dv = vel_s[:, None, :] - cand[..., col_vel:col_vel + d]
    if friction_c > 0.0 and vel is not None:
        w = jnp.where(valid, pen / radius, 0.0)
        f_pair = f_pair - friction_c * w[..., None] * dv
    if mu > 0.0 and vel is not None:
        active = valid & (pen > 0.0)
        n_hat = diff / dist[..., None]
        v_t = dv - jnp.sum(dv * n_hat, axis=-1, keepdims=True) * n_hat
        t_speed = jnp.sqrt(
            jnp.maximum(jnp.sum(v_t * v_t, axis=-1), 1e-24)
        )
        f_n = stiffness * pen  # normal penalty magnitude
        f_t_mag = jnp.minimum(mu_slope * t_speed, mu * f_n)
        f_t_mag = jnp.where(active, f_t_mag, 0.0)
        f_pair = f_pair - (f_t_mag / t_speed)[..., None] * v_t
    f_s = jnp.sum(f_pair, axis=1)  # +f on the finder i
    f_s = f_s.at[j.reshape(-1)].add(
        -f_pair.reshape(-1, d)
    )  # −f on every candidate j
    return jnp.zeros_like(pos).at[order].add(f_s)


def grid_overflow_count(
    pos: np.ndarray, radius: float, cap: int
) -> int:
    """Host-side diagnostic: number of (vertex, neighbor-cell) queries
    whose cell occupancy exceeds ``cap`` at these positions — 0 means the
    grid pass finds exactly the dense pair set."""
    ns, d = pos.shape
    m, _ = grid_shape(radius, d)
    ic = np.clip(np.floor(pos / radius).astype(np.int64) + 1, 0, m - 1)
    strides = np.array([m ** k for k in range(d - 1, -1, -1)])
    cell = (ic * strides[None, :]).sum(1)
    _, counts = np.unique(cell, return_counts=True)
    return int((counts > cap).sum())
