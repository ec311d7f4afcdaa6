# coding=utf-8
"""Nodal assembly: pure-functional scatter of per-element quantities.

The reference assembles per-element vertex contributions with Taichi *atomic*
adds inside GPU kernels (``obj.particles.force[index] += f`` at
solver/explicit.py:46-49, matrix scatter at solver/implicit.py:151-178, mass
lumping at object.py:358-360).  The functional equivalent is a segment
reduction over a flattened (element, local-vertex) axis, which XLA lowers to
a scatter-add (atomic on a GPU, so its summation order may vary), or the
per-particle gather plan below, whose sums are deterministic.

``element_contrib_full`` encodes the reference's universal per-element scatter
pattern: local vertices ``1..d`` each receive a dim-vector (one column of a
d×d block), and local vertex ``0`` receives the *negative sum* of those columns
(force balance — solver/explicit.py:42-49).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def segment_assemble(
    contrib: jnp.ndarray,
    element_indices: jnp.ndarray,
    num_particles: int,
    axis_name: str | None = None,
) -> jnp.ndarray:
    """Scatter-add per-element per-vertex vectors onto particles.

    Args:
      contrib: ``(E, d+1, k)`` per-element contribution for each local vertex.
      element_indices: ``(E, d+1)`` int32 global particle ids.
      num_particles: number of particles N.
      axis_name: when running inside ``shard_map`` with elements sharded over
        a mesh axis, the name of that axis — the local partial sums are
        ``psum``-reduced so every shard holds the full assembly
        (SURVEY §5: the replacement for cross-device atomics).

    Returns:
      ``(N, k)`` summed contributions (replicated across shards if reduced).
    """
    k = contrib.shape[-1]
    out = jax.ops.segment_sum(
        contrib.reshape(-1, k),
        element_indices.reshape(-1),
        num_segments=num_particles,
    )
    if axis_name is not None:
        out = jax.lax.psum(out, axis_name)
    return out


def segment_assemble_scalar(
    contrib: jnp.ndarray, element_indices: jnp.ndarray, num_particles: int
) -> jnp.ndarray:
    """Scatter-add per-element per-vertex scalars: ``(E, d+1) -> (N,)``."""
    return jax.ops.segment_sum(
        contrib.reshape(-1),
        element_indices.reshape(-1),
        num_segments=num_particles,
    )


def build_gather_plan(element_indices, num_particles: int):
    """Precompute the per-particle incidence plan for gather-based assembly.

    Instead of scatter-adding ``E·(d+1)`` rows into N particles, each
    particle *gathers* its own incident contribution rows and sums them —
    a fixed summation order with no atomics.
    Returns ``(N, max_degree)`` int32 of flattened contribution-row ids
    ``e·(d+1)+l``, padded with the sentinel row ``E·(d+1)`` (an all-zero row
    appended at apply time).

    Host-side (numpy), runs once at load.
    """
    import numpy as np

    idx = np.asarray(element_indices)
    e, dp1 = idx.shape
    flat_particle = idx.reshape(-1)
    order = np.argsort(flat_particle, kind="stable")
    sorted_rows = order.astype(np.int64)
    sorted_particles = flat_particle[order]
    counts = np.bincount(sorted_particles, minlength=num_particles)
    maxdeg = int(counts.max()) if counts.size else 0
    sentinel = e * dp1
    plan = np.full((num_particles, maxdeg), sentinel, np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    ranks = np.arange(sorted_rows.shape[0]) - starts[sorted_particles]
    plan[sorted_particles, ranks] = sorted_rows
    return plan.astype(np.int32)


def split_two_tier(plan, counts, min_saving: float = 0.25):
    """Split a (N, maxdeg) gather plan into the two-tier form when the
    degree distribution is skewed enough to pay for it.

    Tet-mesh vertex valence is skewed (flagship: median 12, maxdeg 56 —
    the single-tier plan gathers 56k rows of which half are sentinel
    padding).  Returns ``(lo, hi, out)``:
    ``lo`` is ``(N, cap)`` at the row-count-minimizing cap, ``hi``
    ``(N2, maxdeg-cap)`` holds the remaining rows of the ``out`` outlier
    particles (index-added on top).  ``hi``/``out`` are None — and ``lo``
    is the input plan — when the best split saves less than
    ``min_saving`` of the gathered rows (small/uniform meshes), keeping
    those assemblies bit-identical to the single-tier form.
    """
    import numpy as np

    plan = np.asarray(plan)
    counts = np.asarray(counts)
    n, maxdeg = plan.shape
    if n == 0 or maxdeg <= 1:
        return plan, None, None
    caps = np.arange(1, maxdeg + 1)
    n2_at = np.array([(counts > c).sum() for c in caps])
    cost = n * caps + n2_at * (maxdeg - caps)
    best = int(np.argmin(cost))
    cap = int(caps[best])
    if cap == maxdeg or cost[best] > (1.0 - min_saving) * n * maxdeg:
        return plan, None, None
    outliers = np.nonzero(counts > cap)[0].astype(np.int32)
    return plan[:, :cap], plan[outliers, cap:], outliers


def build_jacobi_plan(element_indices, num_particles: int):
    """Precompute the block-sparse row structure of the implicit system for
    the serial Gauss–Seidel-style Jacobi sweep (solvers/implicit.py::
    jacobi_solve_serial_sparse) — O(E) memory instead of the dense
    (N·d, N·d) matrix the reference materializes (object.py:82-92).

    Each element e (vertices v0, v1..vd) contributes its block K_e to 4·d
    (row, col) pairs of the assembled graph Laplacian (reference scatter,
    solver/implicit.py:151-181): (vi, vi, +), (vi, v0, −), (v0, vi, −),
    (v0, v0, +) for each local i.  Unique pairs become per-row neighbor
    slots ordered by ascending column id.

    Returns (nb_ids (N, max_nb) int32 — neighbor particle id per slot,
    padded with −1 (padded slots carry all-zero blocks; the clamped gather
    they cause is multiplied by those zeros); slot_ids (E, 4d) int32 — flat
    index into (N·max_nb) per contribution; coeff (E, 4d) float32 — ±1 per
    contribution).  Host-side numpy, runs once at load.
    """
    import numpy as np

    idx = np.asarray(element_indices, np.int64)
    e_cnt, dp1 = idx.shape
    d = dp1 - 1
    v0 = np.repeat(idx[:, 0:1], d, axis=1)  # (E, d)
    vi = idx[:, 1:]  # (E, d)
    rows = np.concatenate([vi, vi, v0, v0], axis=1)  # (E, 4d)
    cols = np.concatenate([vi, v0, vi, v0], axis=1)
    ones = np.ones((e_cnt, d), np.float32)
    coeff = np.concatenate([ones, -ones, -ones, ones], axis=1)
    pairs = rows * np.int64(num_particles) + cols
    uniq = np.unique(pairs)
    urows = uniq // num_particles
    counts = np.bincount(urows, minlength=num_particles)
    max_nb = int(counts.max()) if counts.size else 1
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(uniq.size) - starts[urows]
    nb_ids = np.full((num_particles, max_nb), -1, np.int64)
    nb_ids[urows, rank] = uniq % num_particles
    pos = np.searchsorted(uniq, pairs.reshape(-1))
    slot_ids = (urows[pos] * max_nb + rank[pos]).reshape(e_cnt, 4 * d)
    return nb_ids.astype(np.int32), slot_ids.astype(np.int32), coeff


def gather_assemble(
    contrib: jnp.ndarray,
    gather_idx: jnp.ndarray,
    gather_hi: jnp.ndarray | None = None,
    gather_out: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Gather-based assembly: ``(E, d+1, k) -> (N, k)`` using a precomputed
    incidence plan (see :func:`build_gather_plan`).  With ``gather_hi`` /
    ``gather_out`` (see :func:`split_two_tier`) the outlier particles'
    remaining rows are gathered from the compact high tier and index-added."""
    k = contrib.shape[-1]
    flat = contrib.reshape(-1, k)
    flat = jnp.concatenate([flat, jnp.zeros((1, k), flat.dtype)], axis=0)
    out = jnp.sum(flat[gather_idx], axis=1)
    if gather_hi is not None:
        out = out.at[gather_out].add(jnp.sum(flat[gather_hi], axis=1))
    return out


def assemble_for(obj, contrib: jnp.ndarray, axis_name: str | None = None):
    """Dispatch assembly on the object's mode: gather-plan on a single chip,
    psum-reduced segment-sum under shard_map (``obj`` is any object with
    ``assembly_mode, gather_idx, element_indices, particle_cnt``)."""
    if axis_name is None and obj.assembly_mode == "gather":
        return gather_assemble(
            contrib, obj.gather_idx,
            getattr(obj, "gather_hi", None), getattr(obj, "gather_out", None),
        )
    return segment_assemble(
        contrib, obj.element_indices, obj.particle_cnt, axis_name
    )


def element_contrib_full(columns: jnp.ndarray) -> jnp.ndarray:
    """Expand d columns into the (d+1)-vertex contribution pattern.

    Given ``columns`` of shape ``(E, d, d)`` where ``columns[e, :, j]`` is the
    dim-vector destined for local vertex ``j+1``, returns ``(E, d+1, d)`` where
    row 0 is ``-sum_j columns[:, :, j]`` (local vertex 0) and rows ``1..d`` are
    the columns (reference: solver/explicit.py:42-49).
    """
    cols = jnp.swapaxes(columns, -1, -2)  # (E, d, d): [e, j] = column j
    v0 = -jnp.sum(cols, axis=-2, keepdims=True)  # (E, 1, d)
    return jnp.concatenate([v0, cols], axis=-2)  # (E, d+1, d)


def gather_edge_diffs(pos: jnp.ndarray, element_indices: jnp.ndarray) -> jnp.ndarray:
    """Per-element edge matrix X with columns ``p_{j+1} - p_0``.

    Args:
      pos: ``(N, d)`` particle positions (or any per-particle dim-vectors).
      element_indices: ``(E, d+1)``.

    Returns:
      ``(E, d, d)`` with ``X[e, :, j] = pos[idx[e, j+1]] - pos[idx[e, 0]]``
      (reference: solver/explicit.py:12-16).
    """
    p = pos[element_indices]  # (E, d+1, d)
    diffs = p[:, 1:, :] - p[:, 0:1, :]  # (E, d, d): row j = p_{j+1} - p_0
    return jnp.swapaxes(diffs, -1, -2)  # columns = edges
