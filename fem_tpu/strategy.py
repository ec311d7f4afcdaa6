# coding=utf-8
"""Execution strategy: which implementation of an operation runs.

Every path is plain ``jax.numpy``/``lax`` code left to XLA — the gather,
the fused element math and ``segment_sum``/gather-plan assembly that XLA
compiles natively on any backend.  What remains to choose is decided here,
from the input alone (mesh size, sharding, solver semantics), so no other
module branches on an execution strategy of its own.
"""

from __future__ import annotations

# The dense ±1 edge matrix S costs E·d·N floats and two reads per operator
# apply; beyond 16M entries (64 MB) it is never worth holding.
EDGE_MATRIX_MAX_ENTRIES = 16_000_000


def builds_edge_matrix(
    operator_mode: str, n_elements: int, n_particles: int, dim: int
) -> bool:
    """Whether ``build_object`` attaches the dense edge matrix: only when
    ``operator_mode="mxu"`` is asked for and S fits its size cap."""
    return (
        operator_mode == "mxu"
        and n_elements * dim * n_particles <= EDGE_MATRIX_MAX_ENTRIES
    )


def implicit_operator(operator_mode: str, obj, axis_name=None) -> str:
    """Operator for the implicit system: ``"mxu"`` (dense Sᵀ(K∘(Sx))) when
    the object carries the edge matrix (``build_object`` attaches it only
    under ``operator_mode="mxu"``), the mode is not pinned to ``"graph"``
    and the solve runs on one device; otherwise ``"graph"`` (gather,
    per-element block product, gather-plan or segment-sum assembly — O(E)
    per apply)."""
    if operator_mode not in ("auto", "graph", "mxu"):
        raise ValueError(f"unknown operator_mode {operator_mode!r}")
    if (
        operator_mode != "graph"
        and axis_name is None
        and obj.edge_matrix is not None
    ):
        return "mxu"
    return "graph"


def uses_dense_solver(
    solver_backend: str,
    *,
    sharded: bool,
    hessian: str,
    cg_precond: str,
    inelastic: bool,
    constrained: bool,
) -> bool:
    """Whether the semi-implicit solve materializes the reference's dense
    (N·d, N·d) system (solvers/dense.py).  Only on request
    (``solver_backend="dense"``) and only where the dense path implements
    the configured semantics: one device, the reference Hessian and CG
    semantics, no inelastic layers, no Dirichlet pins.  The matrix-free
    operator is O(E) per apply and is used everywhere else."""
    return (
        solver_backend == "dense"
        and not sharded
        and hessian == "reference"
        and cg_precond == "reference"
        and not inelastic
        and not constrained
    )
