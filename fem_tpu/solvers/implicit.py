# coding=utf-8
"""Implicit (backward-Euler-style) integration, matrix-free.

The reference materializes a dense (N,N) grid of dim×dim blocks
A = I − dt²M⁻¹K (object.py:82-92, assembled at solver/implicit.py:114-194) and
runs weighted-Jacobi / CG with O(N²) products per iteration — its scaling
wall.  Because the reference's Hessian blocks vanish for i≠j and coincide for
i==j (``dF = (i==j ? I : 0) @ R_inv``, implicit.py:141-144), each element
contributes a *single* block K_e in a graph-Laplacian pattern, so the exact
same operator is applied here matrix-free in O(E) per iteration:

    (K·x)|_e :  s_j = x_{v_{j+1}} − x_{v_0};  t_j = K_e s_j
                v_{j+1} += t_j,   v_0 −= Σ_j t_j
    A·x = x − dt² · (K·x) / m

Solver semantics match the reference exactly:
  * CG: x₀ = b (implicit.py:314), absolute tolerance ``delta_new > 1e-5``
    (implicit.py:341), ≤500 iterations, optional normal-equations mode
    AᵀAx = Aᵀb when ``preconditioned == 1`` (implicit.py:289-299) — realized
    matrix-free by a double apply with the closed-form Aᵀ (same scatter
    pattern, transposed blocks);
  * weighted Jacobi: x₀ = 0.5·b (implicit.py:232), ω = 0.75 relaxation against
    the previously *cached* iterate (implicit.py:392-404), monotone-error
    check with rollback-and-stop (implicit.py:252-261), tol 1e-5, ≤20000
    iterations.  The relaxation anchor ``past_vec_x`` is carried across steps
    (the reference never clears that field), via ``SimState.jacobi_past_x``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from fem_tpu.models.state import FemObject, SimState
from fem_tpu.ops import smallmat as sm
from fem_tpu.ops.assembly import (
    assemble_for,
    element_contrib_full,
    gather_edge_diffs,
)
from fem_tpu.ops.element import hessian_blocks, implicit_force_columns
from fem_tpu.utils.config import CONJUGATE_GRADIENT_METHOD, JACOBI_METHOD


# ---------------------------------------------------------------------------
# Matrix-free operator
# ---------------------------------------------------------------------------

def graph_block_apply(
    obj: FemObject,
    K: jnp.ndarray,
    x: jnp.ndarray,
    axis_name: str | None = None,
) -> jnp.ndarray:
    """K·x with the element-Laplacian scatter pattern; O(E)."""
    s = gather_edge_diffs(x, obj.element_indices)  # (E, d, d) columns = diffs
    t = sm.matmul(K, s)  # columns t_j = K_e @ s_j
    return assemble_for(obj, element_contrib_full(t), axis_name)


def system_coeff(dt: float, beta: float = 0.0) -> float:
    """Coefficient on M⁻¹·G(K) in the implicit system.

    Reference semantics (implicit.py:183-194): ``dt²``.  With stiffness-
    proportional Rayleigh damping β (ObjectConfig.damping_beta, extension)
    the backward-Euler treatment of the damping force β·G(K)·v' folds into
    the SAME operator: A = I − dt·(dt+β)·M⁻¹·G(K) — no extra applies.
    β = 0 reproduces the reference exactly."""
    return dt * (dt + beta)


def make_system_apply(
    obj: FemObject, K: jnp.ndarray, dt: float, axis_name: str | None = None,
    beta: float = 0.0,
) -> Callable[[jnp.ndarray], jnp.ndarray]:
    """A·x = x − dt·(dt+β)·M⁻¹·(K·x)  (scaling semantics of
    implicit.py:183-194; β = Rayleigh damping extension, 0 = parity)."""
    c = system_coeff(dt, beta)

    def apply_a(x: jnp.ndarray) -> jnp.ndarray:
        kx = graph_block_apply(obj, K, x, axis_name)
        return x - c * kx / obj.mass[:, None]

    return apply_a


def make_system_apply_t(
    obj: FemObject, K: jnp.ndarray, dt: float, axis_name: str | None = None,
    beta: float = 0.0,
) -> Callable[[jnp.ndarray], jnp.ndarray]:
    """Aᵀ·y, exact transpose of :func:`make_system_apply` in closed form
    (replaces the reference's explicit Aᵀ formation, implicit.py:289-292).

    A = I − c·M⁻¹·G(K) ⇒ Aᵀ = I − c·G(K)ᵀ·M⁻¹, and the transpose of the
    graph scatter is the *same* scatter pattern with each block transposed
    ((Gᵀ)[i,j] = G[j,i]ᵀ, symmetric sparsity).
    """
    c = system_coeff(dt, beta)

    def apply_at(y: jnp.ndarray) -> jnp.ndarray:
        z = y / obj.mass[:, None]
        gz = graph_block_apply(obj, sm.mT(K), z, axis_name)
        return y - c * gz

    return apply_at


def diagonal_blocks(
    obj: FemObject, K: jnp.ndarray, dt: float, axis_name: str | None = None,
    beta: float = 0.0,
) -> jnp.ndarray:
    """Per-particle diagonal dim×dim blocks of A (Jacobi + block-Jacobi PCG).

    Diagonal of the assembled K: local vertex 0 of element e receives
    ``d·K_e`` (accumulated once per local i at implicit.py:168), local
    vertices 1..d receive ``K_e`` each.
    """
    d = obj.dim
    w = jnp.concatenate(
        [jnp.full((K.shape[0], 1), float(d)), jnp.ones((K.shape[0], d))], axis=1
    )  # (E, d+1)
    contrib = w[..., None] * K.reshape(K.shape[0], 1, d * d)  # (E, d+1, d*d)
    diag_k = assemble_for(obj, contrib, axis_name).reshape(
        obj.particle_cnt, d, d
    )
    eye = jnp.eye(d, dtype=K.dtype)[None]
    return eye - system_coeff(dt, beta) * diag_k / obj.mass[:, None, None]


def diagonal_blocks_from(
    element_indices: jnp.ndarray,
    K: jnp.ndarray,
    mass: jnp.ndarray,
    dt: float,
    num_particles: int,
    axis_name: str | None = None,
    beta: float = 0.0,
) -> jnp.ndarray:
    """:func:`diagonal_blocks` over explicit element arrays (the κ-estimate
    and Newton's decoupled Jacobian pass their own; zero-volume padded
    elements have K = 0 exactly, so they contribute nothing)."""
    from fem_tpu.ops.assembly import segment_assemble

    e, dp1 = element_indices.shape
    d = dp1 - 1
    w = jnp.concatenate(
        [jnp.full((e, 1), float(d)), jnp.ones((e, d))], axis=1
    )
    contrib = w[..., None] * K.reshape(e, 1, d * d)
    diag_k = segment_assemble(
        contrib, element_indices, num_particles, axis_name
    ).reshape(num_particles, d, d)
    eye = jnp.eye(d, dtype=K.dtype)[None]
    return eye - system_coeff(dt, beta) * diag_k / mass[:, None, None]


def build_edge_matrix(element_indices, num_particles: int):
    """Dense ±1 edge-difference operator S of shape (E·d, N):
    ``(S x)[e·d+j] = x[v_{j+1}] − x[v_0]`` — so the element-Laplacian product
    is two matrix products, ``G(K)·x = Sᵀ·(K ∘ (S x))``.

    The "mxu" operator mode replaces the gather/einsum/scatter chain per
    application with 3 dense ops.  Dense S is O(E·d·N) memory — viable for
    small/medium meshes only (fem_tpu/strategy.builds_edge_matrix).
    Host-side, runs once at load.
    """
    import numpy as np

    idx = np.asarray(element_indices)
    e, dp1 = idx.shape
    d = dp1 - 1
    s = np.zeros((e * d, num_particles), np.float32)
    rows = np.arange(e * d)
    s[rows, idx[:, 1:].reshape(-1)] += 1.0
    s[rows, np.repeat(idx[:, 0], d)] -= 1.0
    return s


def make_mxu_system_apply(
    obj: FemObject, K: jnp.ndarray, s_mat: jnp.ndarray, dt: float,
    beta: float = 0.0,
):
    """(apply_a, apply_at) in the dense edge-matrix formulation.  ``s_mat`` is the dense S
    from :func:`build_edge_matrix`; K blocks reshape to (E·d, d) row blocks so
    ``K ∘ t`` is one einsum."""
    e, d = K.shape[0], obj.dim
    hp = jax.lax.Precision.HIGHEST
    c = system_coeff(dt, beta)

    def g_apply(k_blocks, x):
        s = jnp.dot(s_mat, x, precision=hp)  # row (e,j) = edge diff vector j
        # t[e,j,:] = K_e @ s[e,j,:]  (contract component axis k)
        t = jnp.einsum(
            "eik,ejk->eji", k_blocks, s.reshape(e, d, d), precision=hp
        ).reshape(e * d, d)
        return jnp.dot(s_mat.T, t, precision=hp)

    def apply_a(x):
        return x - c * g_apply(K, x) / obj.mass[:, None]

    def apply_at(y):
        return y - c * g_apply(sm.mT(K), y / obj.mass[:, None])

    return apply_a, apply_at


def make_exact_hvp_apply(
    obj: FemObject,
    pos: jnp.ndarray,
    dt: float,
    axis_name: str | None = None,
    robust: bool = False,
    beta: float = 0.0,
    layers=None,
) -> Callable[[jnp.ndarray], jnp.ndarray]:
    """Extension: the *true* Newton operator A = I − dt²·M⁻¹·∂f/∂x via a
    Hessian-vector product (``jax.jvp`` of the assembled elastic force).

    The reference's block Hessian (``hessian_blocks``) drops all cross-vertex
    coupling (solver/implicit.py:141-144) — the exact linearization couples
    every vertex pair of an element.  Selected via ``hessian="exact_jvp"``
    (SimConfig extension); O(E) per application like the reference operator.
    Material-aware: for StVK/linear this is the ONLY implicit operator (the
    decoupled formula is NH-specific).
    """

    c = system_coeff(dt, beta)

    def force(p: jnp.ndarray) -> jnp.ndarray:
        cols = _material_force_columns(obj, p, robust, layers, axis_name)
        return assemble_for(obj, element_contrib_full(cols), axis_name)

    def apply_a(x: jnp.ndarray) -> jnp.ndarray:
        _, df_x = jax.jvp(force, (pos,), (x,))
        return x - c * df_x / obj.mass[:, None]

    return apply_a


def rayleigh_damping_grad(
    obj: FemObject,
    pos: jnp.ndarray,
    vel: jnp.ndarray,
    axis_name: str | None = None,
    layers=None,
) -> jnp.ndarray:
    """Energy-gradient contribution of stiffness-proportional Rayleigh
    damping for the explicit/autodiff paths: −β·G(K)·v, where G(K) is the
    decoupled block-Hessian operator (≈ ∂f/∂x, negative semi-definite — so
    the damping force β·G(K)·v is dissipative and leaves rigid-body motion
    untouched).  Returned in the reference's *gradient* sign convention
    (added to ``particles.force``, subtracted in kinematic —
    solver/kinematic.py:19).  Extension; β = obj.damping_beta."""
    from fem_tpu.ops.inelastic import layer_ref_inv_local

    K = None
    for fi_inv, mu, lam, material in _normalize_layers(obj, layers):
        r_eff = layer_ref_inv_local(obj.ref_inv, fi_inv, axis_name)
        k_l = hessian_blocks(
            pos, obj.element_indices, r_eff, obj.volume, mu, lam, False,
            material,
        )
        K = k_l if K is None else K + k_l
    kv = graph_block_apply(obj, K, vel, axis_name)
    return -obj.damping_beta * kv


# ---------------------------------------------------------------------------
# Right-hand side
# ---------------------------------------------------------------------------

def _one_layer_force_columns(
    pos: jnp.ndarray,
    element_indices: jnp.ndarray,
    ref_inv: jnp.ndarray,
    volume: jnp.ndarray,
    mu: float,
    lam: float,
    material: str,
    robust: bool,
) -> jnp.ndarray:
    """Implicit rhs force columns for ONE material layer: the reference's
    implicit NH chain (``implicit_force_columns`` — λ/2·log(det FᵀF) form,
    implicit.py:87-88) for neo_hookean, or −V·first_piola(F)·R⁻ᵀ for the
    other materials (ops/element.first_piola_dp)."""
    if material == "neo_hookean":
        return implicit_force_columns(
            pos, element_indices, ref_inv, volume, mu, lam, robust,
        )
    from fem_tpu.ops.element import explicit_grad_columns

    return -explicit_grad_columns(
        pos, element_indices, ref_inv, volume, mu, lam, material,
    )


def _normalize_layers(obj: FemObject, layers) -> tuple:
    """``layers`` (ops/inelastic.material_layers tuples, or None) → always a
    tuple of (fi_inv, mu, lam, material); None means the single pure-elastic
    layer, whose generated computation is identical to the historical
    non-layered code (fi_inv=None composes to the object's own ref_inv)."""
    if layers is None:
        return ((None, obj.mu, obj.s_lambda, obj.material),)
    return tuple(layers)


def _is_layered(layers) -> bool:
    return layers is not None and (
        len(layers) > 1 or any(fi is not None for fi, _, _, _ in layers)
    )


def _material_force_columns(
    obj: FemObject, pos: jnp.ndarray, robust: bool, layers=None,
    axis_name: str | None = None,
) -> jnp.ndarray:
    """Force columns summed over material layers (single elastic layer when
    ``layers`` is None — the historical behavior, bit-identical)."""
    from fem_tpu.ops.inelastic import layer_ref_inv_local

    total = None
    for fi_inv, mu, lam, material in _normalize_layers(obj, layers):
        r_eff = layer_ref_inv_local(obj.ref_inv, fi_inv, axis_name)
        cols = _one_layer_force_columns(
            pos, obj.element_indices, r_eff, obj.volume, mu, lam, material,
            robust,
        )
        total = cols if total is None else total + cols
    return total


def _k_and_force_cols(
    obj: FemObject,
    pos: jnp.ndarray,
    element_indices: jnp.ndarray,
    ref_inv: jnp.ndarray,
    volume: jnp.ndarray,
    robust: bool,
    mu: float | None = None,
    lam: float | None = None,
    material: str | None = None,
):
    """(K blocks, rhs force columns) on the given element arrays, material-
    aware.  ``mu``/``lam``/``material`` default to the object's (overridden
    per material layer by the inelastic extension)."""
    mu = obj.mu if mu is None else mu
    lam = obj.s_lambda if lam is None else lam
    material = obj.material if material is None else material
    k_flat = hessian_blocks(
        pos, element_indices, ref_inv, volume, mu, lam, robust, material,
    )
    cols = _one_layer_force_columns(
        pos, element_indices, ref_inv, volume, mu, lam, material, robust,
    )
    return k_flat, cols


def _k_and_force_cols_layers(
    obj: FemObject,
    pos: jnp.ndarray,
    element_indices: jnp.ndarray,
    ref_inv: jnp.ndarray,
    volume: jnp.ndarray,
    robust: bool,
    layers,
    axis_name: str | None = None,
):
    """:func:`_k_and_force_cols` summed over material layers; the dynamic
    internal inverses compose in the (possibly shard-local) element
    order."""
    from fem_tpu.ops.inelastic import layer_ref_inv_local

    k_total = cols_total = None
    for fi_inv, mu, lam, material in _normalize_layers(obj, layers):
        r_eff = layer_ref_inv_local(ref_inv, fi_inv, axis_name)
        k, cols = _k_and_force_cols(
            obj, pos, element_indices, r_eff, volume, robust,
            mu, lam, material,
        )
        k_total = k if k_total is None else k_total + k
        cols_total = cols if cols_total is None else cols_total + cols
    return k_total, cols_total


def implicit_rhs(
    obj: FemObject, state: SimState, dt: float, axis_name: str | None = None,
    robust: bool = False, layers=None,
) -> jnp.ndarray:
    """b = v + dt·M⁻¹·f_elastic (implicit.py:65-107), summed over material
    layers (``layers`` None = the single elastic layer, historical path)."""
    from fem_tpu.ops.inelastic import layer_ref_inv_local

    cols_total = None
    for fi_inv, mu, lam, material in _normalize_layers(obj, layers):
        r_eff = layer_ref_inv_local(obj.ref_inv, fi_inv, axis_name)
        cols = _one_layer_force_columns(
            state.pos, obj.element_indices, r_eff, obj.volume,
            mu, lam, material, robust,
        )
        cols_total = cols if cols_total is None else cols_total + cols
    f = assemble_for(obj, element_contrib_full(cols_total), axis_name)
    return state.vel + dt * f / obj.mass[:, None]


# ---------------------------------------------------------------------------
# Conjugate gradient (reference loop semantics, implicit.py:311-386)
# ---------------------------------------------------------------------------

class CGResult(NamedTuple):
    x: jnp.ndarray
    iterations: jnp.ndarray
    residual: jnp.ndarray  # final delta_new = rᵀr


def _vdot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.sum(a * b)


def conjugate_gradient(
    operator: Callable[[jnp.ndarray], jnp.ndarray],
    rhs: jnp.ndarray,
    x0: jnp.ndarray,
    max_iter: int = 500,
    tol: float = 1e-5,
) -> CGResult:
    """Reference-parity CG under ``lax.while_loop``: absolute tolerance on
    ``delta_new`` and no restart recomputation (the i%50 branch is commented
    out in the reference, implicit.py:360-369)."""
    r0 = rhs - operator(x0)
    carry0 = (x0, r0, r0, _vdot(r0, r0), jnp.int32(0))

    def cond(c):
        _, _, _, delta_new, it = c
        return (it < max_iter) & (delta_new > tol)

    def body(c):
        x, r, d, delta_new, it = c
        q = operator(d)
        alpha = delta_new / _vdot(d, q)
        x = x + alpha * d
        r = r - alpha * q
        delta_next = _vdot(r, r)
        beta = delta_next / delta_new
        d = r + beta * d
        return (x, r, d, delta_next, it + 1)

    x, _, _, delta, it = jax.lax.while_loop(cond, body, carry0)
    return CGResult(x=x, iterations=it, residual=delta)


def preconditioned_conjugate_gradient(
    operator: Callable[[jnp.ndarray], jnp.ndarray],
    diag: jnp.ndarray,  # (N, d, d) diagonal blocks of A (diagonal_blocks)
    mass: jnp.ndarray,  # (N,) lumped particle masses
    rhs: jnp.ndarray,
    x0: jnp.ndarray,
    max_iter: int = 500,
    tol: float = 1e-5,
) -> CGResult:
    """Block-Jacobi PCG — the ``cg_precond="block_jacobi"`` extension.

    The reference's only "preconditioner" is normal-equations CG
    (AᵀAx = Aᵀb, solver/implicit.py:289-299), which *doubles* operator
    applies per iteration and squares the condition number (on the 10⁵-tet
    grid body it takes 7 CG iterations per substep against 4 for plain CG —
    chip_smoke.py phase (d)).  This is an
    actual preconditioner: M⁻¹ = (symmetrized per-particle d×d diagonal
    blocks of A)⁻¹ — the blocks :func:`diagonal_blocks` already assembles
    for Jacobi — applied as one tiny batched matmul per iteration, with
    exactly 1 operator apply per iteration.

    The Krylov process runs on the mass-symmetrized similarity transform
    Ã = M^{1/2}·A·M^{-1/2} = I − dt²·M^{-1/2}·G(K)·M^{-1/2} (same system,
    same solution): A itself is nonsymmetric through the M⁻¹ row scaling,
    and raw PCG on it was measured to STALL under strong mass heterogeneity
    while the symmetrized form converges robustly (tests/test_cg_precond).
    Ã's diagonal blocks equal A's, so the same ``diag`` serves.  The extra
    cost is two elementwise √m multiplies per apply.

    Termination stays the reference's ABSOLUTE ``rᵀr > tol`` test on the
    ORIGINAL residual b − A·x (implicit.py:341), so accepted solutions are
    interchangeable with the reference CG's; x₀ = b kept (implicit.py:314).
    """
    hp = jax.lax.Precision.HIGHEST
    sq = jnp.sqrt(mass)[:, None]
    dsym = 0.5 * (diag + sm.mT(diag))
    # Per-block trust test (Gershgorin): at κ = dt²‖K‖/m ≈ 1 the diagonal
    # blocks of A = I − dt²·M⁻¹·diag(K) are near-singular/indefinite, and
    # ANY use of them poisons the Krylov directions — measured at 68k tets
    # / dt=5e-4 under the Newton integrator: the raw inverse diverges
    # outright, and an SPD *shift* that merely guarantees positive
    # definiteness still leaves cond(M) ~ 1/δ in the bad blocks and the
    # solve hits its iteration cap in regimes plain CG handles in a
    # handful.  So: use the exact block ONLY where it is diagonally
    # dominant with margin (every regime where block-Jacobi has something
    # to offer — heterogeneous mass/stiffness keeps large POSITIVE
    # diagonals); elsewhere substitute that block's scaled identity, which
    # makes the preconditioner locally equivalent to plain CG.  Benign
    # blocks are bit-identical to the unguarded inverse.
    absdiag = jnp.abs(jnp.diagonal(dsym, axis1=-2, axis2=-1))
    offdiag = jnp.sum(jnp.abs(dsym), axis=-1) - absdiag
    gersh_min = jnp.min(
        jnp.diagonal(dsym, axis1=-2, axis2=-1) - offdiag, axis=-1
    )
    scale = jnp.mean(absdiag, axis=-1) + 1e-30
    ok = (gersh_min >= 0.05 * scale)[:, None, None]
    eye = jnp.eye(diag.shape[-1], dtype=diag.dtype)[None]
    safe = jnp.where(ok, dsym, scale[:, None, None] * eye)
    minv = sm.inv(safe)

    def op(y):
        return sq * operator(y / sq)

    def apply_m(r):
        return jnp.einsum("nij,nj->ni", minv, r, precision=hp)

    def rr_orig(r):
        return _vdot(r / sq, r / sq)

    y0 = sq * x0
    r0 = sq * rhs - op(y0)
    z0 = apply_m(r0)
    carry0 = (y0, r0, z0, _vdot(r0, z0), rr_orig(r0), jnp.int32(0))

    def cond(c):
        _, _, _, _, rr, it = c
        return (it < max_iter) & (rr > tol)

    def body(c):
        y, r, d, delta, _, it = c
        q = op(d)
        alpha = delta / _vdot(d, q)
        y = y + alpha * d
        r = r - alpha * q
        z = apply_m(r)
        delta_next = _vdot(r, z)
        beta = delta_next / delta
        d = z + beta * d
        return (y, r, d, delta_next, rr_orig(r), it + 1)

    y, _, _, _, rr, it = jax.lax.while_loop(cond, body, carry0)
    return CGResult(x=y / sq, iterations=it, residual=rr)


def _cg_solve_dispatch(
    apply_a: Callable[[jnp.ndarray], jnp.ndarray],
    apply_at_fn: Callable[[], Callable[[jnp.ndarray], jnp.ndarray]],
    b: jnp.ndarray,
    preconditioned: int,
    cg_precond: str,
    diag_fn: Callable[[], jnp.ndarray] | None,
    mass: jnp.ndarray | None = None,
    free: jnp.ndarray | None = None,
    pin_vel: jnp.ndarray | None = None,
    two_level_fn: Callable[[], tuple] | None = None,
) -> CGResult:
    """Route one CG solve by ``cg_precond``:

    * ``"reference"`` (parity default): honor the config's ``preconditioned``
      int — normal-equations AᵀAx = Aᵀb when 1 (implicit.py:289-299), plain
      CG otherwise;
    * ``"none"``: force plain CG (one operator apply per iteration, the
      cheapest reference-semantics variant) regardless of
      ``preconditioned``;
    * ``"block_jacobi"``: block-Jacobi PCG on A (extension);
    * ``"two_level"``: PCG with the coarse-space V-cycle preconditioner
      (solvers/multilevel.py — ``two_level_fn`` thunk supplies the coarse
      space + assembled/factored coarse matrix).

    ``apply_at_fn`` / ``diag_fn`` are thunks so the transpose operator and
    the diagonal blocks are only materialized when the mode needs them.

    ``free`` (N, 1, Dirichlet extension — ObjectConfig.pin_boxes) applies the
    standard constraint projection around ANY operator backend: the solve
    runs on Â = P·A·P + (I − P), b̂ = P·b with P = diag(free) — symmetric-
    positive-definite whenever A is, identity rows on pinned vertices, and
    the solution satisfies x_pinned = 0 exactly.  Âᵀ projects the same way;
    Â's diagonal blocks are P·diag(A)·P + (I−P)·I for the PCG mode.

    ``pin_vel`` (N, d) turns the projection inhomogeneous (prescribed-motion
    pins): with particular solution x_h = (I−P)·v_pin the solve runs on
    b̂ = P·(b − A·x_h) + x_h, so the free rows see the constraint's reaction
    and the solution satisfies x_pinned = v_pin exactly."""
    if free is not None:
        base_a, base_at_fn, base_diag = apply_a, apply_at_fn, diag_fn
        held = 1.0 - free

        def apply_a(x, _a=base_a):
            return free * _a(free * x) + held * x

        def apply_at_fn(_fn=base_at_fn):
            at = _fn()
            return lambda y: free * at(free * y) + held * y

        if base_diag is not None:

            def diag_fn(_d=base_diag):
                diag = _d()
                eye = jnp.eye(diag.shape[-1], dtype=diag.dtype)[None]
                f3 = free[..., None]  # (N, 1, 1)
                return f3 * diag + (1.0 - f3) * eye

        if pin_vel is not None:
            x_h = held * pin_vel
            b = free * (b - base_a(x_h)) + x_h
        else:
            b = free * b
    if cg_precond == "block_jacobi":
        if diag_fn is None:
            raise ValueError(
                "cg_precond='block_jacobi' requires explicit diagonal "
                "blocks; unavailable for hessian='exact_jvp' (use "
                "cg_precond='none' there)"
            )
        return preconditioned_conjugate_gradient(
            apply_a, diag_fn(), mass, b, x0=b
        )
    from fem_tpu.solvers.multilevel import parse_two_level_precond

    tl, tl_smoother, tl_degree = parse_two_level_precond(cg_precond)
    if tl:
        if two_level_fn is None or diag_fn is None:
            raise ValueError(
                "cg_precond='two_level' requires explicit K blocks and the "
                "attached coarse space; unavailable for "
                "hessian='exact_jvp' (use cg_precond='none' there)"
            )
        from fem_tpu.solvers.multilevel import two_level_pcg

        coarse, c_mat = two_level_fn()
        return two_level_pcg(
            apply_a, diag_fn(), mass, coarse, c_mat, b, x0=b,
            free_mask=free, smoother=tl_smoother, cheb_degree=tl_degree,
        )
    if cg_precond not in ("reference", "none"):
        raise ValueError(f"unknown cg_precond {cg_precond!r}")
    if cg_precond == "reference" and preconditioned == 1:
        apply_at = apply_at_fn()
        operator = lambda v: apply_at(apply_a(v))
        return conjugate_gradient(operator, apply_at(b), x0=b)
    return conjugate_gradient(apply_a, b, x0=b)


# ---------------------------------------------------------------------------
# Weighted Jacobi with rollback (implicit.py:226-261, 390-404)
# ---------------------------------------------------------------------------

class JacobiResult(NamedTuple):
    x: jnp.ndarray
    past_x: jnp.ndarray  # cached iterate to persist across steps
    iterations: jnp.ndarray
    error: jnp.ndarray


def _jacobi_outer_loop(
    once: Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray],
    error: Callable[[jnp.ndarray], jnp.ndarray],
    b: jnp.ndarray,
    past_x: jnp.ndarray,
    tol: float,
    max_iter: int,
) -> JacobiResult:
    """The reference's outer iteration (implicit.py:226-261): x₀ = 0.5·b,
    ‖b−Ax‖ recomputed per iteration, monotone-error rollback-and-stop, the
    accepted iterate cached as the next relaxation anchor."""
    x0 = 0.5 * b
    err0 = error(x0)
    carry0 = (x0, past_x, err0, err0, jnp.int32(0), jnp.bool_(False))

    def cond(c):
        _, _, err, _, it, done = c
        return (~done) & (err > tol) & (it < max_iter)

    def body(c):
        x, past, err, p_err, it, done = c
        x1 = once(x, past)
        e1 = error(x1)
        rollback = e1 >= p_err
        x_out = jnp.where(rollback, past, x1)
        past_out = jnp.where(rollback, past, x1)
        p_err_out = jnp.where(rollback, p_err, e1)
        return (x_out, past_out, e1, p_err_out, it + 1, rollback)

    x, past, err, _, it, _ = jax.lax.while_loop(cond, body, carry0)
    return JacobiResult(x=x, past_x=past, iterations=it, error=err)


def jacobi_solve(
    operator: Callable[[jnp.ndarray], jnp.ndarray],
    diag: jnp.ndarray,  # (N, d, d) diagonal blocks of A
    b: jnp.ndarray,
    past_x: jnp.ndarray,
    omega: float = 0.75,
    tol: float = 1e-5,
    max_iter: int = 20000,
) -> JacobiResult:
    """Snapshot (true parallel) weighted-Jacobi sweep — the ``jacobi_sweep=
    "snapshot"`` extension; O(E) matrix-free per iteration.  The reference's
    sweep actually executes serially (see :func:`jacobi_solve_serial`, the
    parity default)."""
    diag_kk = jnp.diagonal(diag, axis1=-2, axis2=-1)  # (N, d) entries A_ii[k,k]

    def once(x, past):
        """One damped-Jacobi sweep (implicit.py:391-404) with snapshot
        semantics: every row reads the previous iterate."""
        resid = b - operator(x)  # b − A·x, full rows
        num = resid + diag_kk * x
        safe = jnp.abs(diag_kk) >= 1e-6
        upd = omega * num / jnp.where(safe, diag_kk, 1.0) + (1.0 - omega) * past
        return jnp.where(safe, upd, 0.0)

    def error(x):
        r = b - operator(x)
        return jnp.sqrt(jnp.sum(r * r))

    return _jacobi_outer_loop(once, error, b, past_x, tol, max_iter)


def jacobi_solve_serial(
    a_dense: jnp.ndarray,  # (N·d, N·d) materialized system
    b: jnp.ndarray,  # (N, d)
    past_x: jnp.ndarray,  # (N, d)
    omega: float = 0.75,
    tol: float = 1e-5,
    max_iter: int = 20000,
) -> JacobiResult:
    """Serial Gauss–Seidel-style weighted sweep — the reference's *actual*
    execution semantics (parity default; analysis in PARITY.md).

    ``jacobi_iter_field_once`` (reference implicit.py:391-404) is a
    ``@ti.func`` inlined inside the serial ``while`` of ``jacobi_iter_field``
    (implicit.py:252-261); Taichi parallelizes only for-loops at a kernel's
    outermost scope, so the particle loop runs serially and row i reads
    ``vec_x[j]`` values already updated this sweep for j < i.  Within a row,
    the residual is computed from the full *old* x_i before any component
    update (the j-loop covers j == i and precedes the component loop), only
    the scalar diagonal A_ii[k,k] is added back, and the ω-relaxation anchors
    on the previously cached iterate ``past_vec_x``.

    Realized as a ``lax.scan`` over particle rows (one (d, N·d) matvec per
    row) inside the shared outer while-loop.  O(N²·d²) per sweep like the
    reference; the Jacobi path only runs on small 2D meshes.
    """
    n, d = b.shape
    nd = n * d
    hp = jax.lax.Precision.HIGHEST
    a_rows = a_dense.reshape(n, d, nd)
    diag_kk = jnp.diagonal(a_dense).reshape(n, d)
    safe = jnp.abs(diag_kk) >= 1e-6
    safe_diag = jnp.where(safe, diag_kk, 1.0)
    row_ids = jnp.arange(n)

    def once(x, past):
        def row(xc, inp):
            i, a_i, b_i, dg_i, sf_i, sd_i, past_i = inp
            ax = jnp.dot(a_i, xc.reshape(-1), precision=hp)  # (d,)
            num = b_i - ax + dg_i * xc[i]
            upd = omega * num / sd_i + (1.0 - omega) * past_i
            return xc.at[i].set(jnp.where(sf_i, upd, 0.0)), None

        x1, _ = jax.lax.scan(
            row, x, (row_ids, a_rows, b, diag_kk, safe, safe_diag, past)
        )
        return x1

    def error(x):
        r = b.reshape(-1) - jnp.dot(a_dense, x.reshape(-1), precision=hp)
        return jnp.sqrt(jnp.sum(r * r))

    return _jacobi_outer_loop(once, error, b, past_x, tol, max_iter)


def sparse_system_rows(
    obj: FemObject, K: jnp.ndarray, dt: float, axis_name: str | None = None,
    beta: float = 0.0,
) -> jnp.ndarray:
    """Block-sparse rows of A = I − dt²M⁻¹K over the precomputed neighbor
    slots (ops/assembly.py::build_jacobi_plan) — the O(E) replacement for
    ``dense.assemble_dense_system`` in the serial Jacobi sweep.

    Returns (N, max_nb, d, d): slot k of row i holds the block
    A[i, nb_ids[i, k]] (zero on padded slots).  Under sharding each shard
    scatters its elements' K into the global-static slot layout and a psum
    completes the rows.
    """
    d, n = obj.dim, obj.particle_cnt
    max_nb = obj.jacobi_nb.shape[1]
    vals = K[:, None, :, :] * obj.jacobi_coeff[..., None, None]  # (E,4d,d,d)
    acc = jax.ops.segment_sum(
        vals.reshape(-1, d * d),
        obj.jacobi_slots.reshape(-1),
        num_segments=n * max_nb,
    )
    if axis_name is not None:
        acc = jax.lax.psum(acc, axis_name)
    acc = acc.reshape(n, max_nb, d, d)
    a = -system_coeff(dt, beta) * acc / obj.mass[:, None, None, None]
    # Padded slots carry nb_id −1, so the self test is exact for every row.
    self_slot = (
        obj.jacobi_nb == jnp.arange(n, dtype=obj.jacobi_nb.dtype)[:, None]
    )
    eye = jnp.eye(d, dtype=a.dtype)
    return a + self_slot[..., None, None] * eye[None, None]


def jacobi_solve_serial_sparse(
    nb_ids: jnp.ndarray,  # (N, max_nb) int32 neighbor ids
    blocks: jnp.ndarray,  # (N, max_nb, d, d) rows of A (sparse_system_rows)
    b: jnp.ndarray,  # (N, d)
    past_x: jnp.ndarray,  # (N, d)
    omega: float = 0.75,
    tol: float = 1e-5,
    max_iter: int = 20000,
) -> JacobiResult:
    """Serial Gauss–Seidel-style weighted sweep over block-sparse rows —
    identical sweep semantics to :func:`jacobi_solve_serial` (row i reads
    values already updated this sweep for j < i, full old x_i in the row
    residual, scalar diagonal added back, ω anchored on ``past_vec_x``;
    reference implicit.py:391-404 serialization analysis in PARITY.md) at
    O(E) per sweep instead of the dense O(N²·d²) row scan.  Summation runs
    over neighbor slots in ascending column order; agreement with the dense
    sweep is float-roundoff-level, pinned by test_implicit."""
    n, d = b.shape
    hp = jax.lax.Precision.HIGHEST
    self_slot = nb_ids == jnp.arange(n, dtype=nb_ids.dtype)[:, None]
    diag_blocks = jnp.sum(
        jnp.where(self_slot[..., None, None], blocks, 0.0), axis=1
    )  # (N, d, d) — see sparse_system_rows for why row 0's padding is safe
    diag_kk = jnp.diagonal(diag_blocks, axis1=-2, axis2=-1)  # (N, d)
    safe = jnp.abs(diag_kk) >= 1e-6
    safe_diag = jnp.where(safe, diag_kk, 1.0)
    row_ids = jnp.arange(n)

    def once(x, past):
        def row(xc, inp):
            i, nb_i, bl_i, b_i, dg_i, sf_i, sd_i, past_i = inp
            xn = xc[nb_i]  # (max_nb, d) current iterate incl. j<i updates
            ax = jnp.einsum("kij,kj->i", bl_i, xn, precision=hp)
            num = b_i - ax + dg_i * xc[i]
            upd = omega * num / sd_i + (1.0 - omega) * past_i
            return xc.at[i].set(jnp.where(sf_i, upd, 0.0)), None

        x1, _ = jax.lax.scan(
            row, x,
            (row_ids, nb_ids, blocks, b, diag_kk, safe, safe_diag, past),
        )
        return x1

    def error(x):
        ax = jnp.einsum("nkij,nkj->ni", blocks, x[nb_ids], precision=hp)
        r = b - ax
        return jnp.sqrt(jnp.sum(r * r))

    return _jacobi_outer_loop(once, error, b, past_x, tol, max_iter)


# ---------------------------------------------------------------------------
# Top-level implicit solve (implicit_solver_neo_hookean, implicit.py:201-223)
# ---------------------------------------------------------------------------

class ImplicitAux(NamedTuple):
    iterations: jnp.ndarray
    residual: jnp.ndarray


def implicit_velocity_solve(
    obj: FemObject,
    state: SimState,
    dt: float,
    method: int,
    preconditioned: int,
    axis_name: str | None = None,
    robust: bool = False,
    hessian: str = "reference",
    operator_mode: str = "graph",
    jacobi_sweep: str = "serial",
    cg_precond: str = "reference",
    layers=None,
) -> Tuple[SimState, ImplicitAux]:
    """Assemble (matrix-free) and solve for the new velocity; returns the
    updated state (vel ← x, implicit.py:222-223) plus solver metrics.

    With ``axis_name`` the element arrays in ``obj`` are per-shard slices and
    every assembly psum-reduces over the mesh axis; the particle-space CG /
    Jacobi iterations run replicated on every shard (identical arithmetic →
    identical iterates, no divergence).

    ``layers`` (ops/inelastic.material_layers, inelastic extension) sums the
    operator / rhs over material layers with dynamic effective rest-edge
    inverses on every operator (graph/mxu); None = the single elastic
    layer (bit-identical to the historical path).  The operator is chosen
    by fem_tpu/strategy.implicit_operator.
    """
    from fem_tpu.strategy import implicit_operator

    layered = _is_layered(layers)
    if layered and method != CONJUGATE_GRADIENT_METHOD:
        raise ValueError(
            "inelastic materials support only the CG solver "
            "(implicit_method=1); the Jacobi sweeps keep pure "
            "reference semantics"
        )
    # Stiffness-proportional Rayleigh damping (ObjectConfig.damping_beta,
    # extension): backward-Euler on β·G(K)·v' folds into the system
    # coefficient — A = I − dt·(dt+β)·M⁻¹·G(K) — so every operator backend
    # supports it at zero extra applies (system_coeff).  β=0 is parity.
    beta = obj.damping_beta
    # Material extensions ride the reference's decoupled one-block-per-
    # element structure with the material's own DP(F)[R⁻¹] integrand
    # (ops/element.first_piola_dp) under hessian="reference", so they get
    # both operators (graph/mxu); hessian="exact_jvp"
    # remains the true-Newton alternative for every material.
    if hessian == "exact_jvp":
        if method != CONJUGATE_GRADIENT_METHOD:
            raise ValueError(
                "hessian='exact_jvp' supports only the CG solver (Jacobi "
                "needs explicit diagonal blocks)"
            )
        apply_a = make_exact_hvp_apply(
            obj, state.pos, dt, axis_name, robust, beta, layers
        )
        b = implicit_rhs(obj, state, dt, axis_name, robust, layers)
        # ∂f/∂x of a conservative force is symmetric ⇒ Aᵀ = I − dt²·Jᵀ·M⁻¹
        # realized with the VJP of the same force function.
        def force(p):
            cols = _material_force_columns(obj, p, robust, layers, axis_name)
            return assemble_for(obj, element_contrib_full(cols), axis_name)

        _, vjp_fn = jax.vjp(force, state.pos)

        def apply_at(y):
            (jt,) = vjp_fn(y / obj.mass[:, None])
            return y - system_coeff(dt, beta) * jt

        res = _cg_solve_dispatch(
            apply_a, lambda: apply_at, b, preconditioned, cg_precond, None,
            free=obj.free_mask, pin_vel=obj.pin_vel,
        )
        return state.replace(vel=res.x), ImplicitAux(res.iterations, res.residual)

    if layered:
        from fem_tpu.ops.inelastic import layer_ref_inv_local

        K = None
        for fi_inv, mu, lam, material in _normalize_layers(obj, layers):
            r_eff = layer_ref_inv_local(obj.ref_inv, fi_inv, axis_name)
            k_l = hessian_blocks(
                state.pos, obj.element_indices, r_eff, obj.volume,
                mu, lam, robust, material,
            )
            K = k_l if K is None else K + k_l
        b = implicit_rhs(obj, state, dt, axis_name, robust, layers)
    else:
        K = hessian_blocks(
            state.pos, obj.element_indices, obj.ref_inv, obj.volume,
            obj.mu, obj.s_lambda, robust, obj.material,
        )
        b = implicit_rhs(obj, state, dt, axis_name, robust)
    use_mxu = implicit_operator(operator_mode, obj, axis_name) == "mxu"
    if use_mxu:
        apply_a, apply_at_mxu = make_mxu_system_apply(
            obj, K, obj.edge_matrix, dt, beta
        )
    else:
        apply_a = make_system_apply(obj, K, dt, axis_name, beta)

    if method == JACOBI_METHOD:
        if obj.free_mask is not None:
            raise ValueError(
                "pin_boxes (Dirichlet constraints) support only the CG "
                "solver; the Jacobi sweeps keep pure reference semantics"
            )
        if jacobi_sweep == "serial":
            # Parity default: serial Gauss–Seidel-style sweep.  Runs over
            # block-sparse neighbor rows (O(E) per sweep) when the plan is
            # attached; the dense row scan remains as fallback and as the
            # cross-check target (test_implicit).
            if obj.jacobi_nb is not None:
                rows_a = sparse_system_rows(obj, K, dt, axis_name, beta)
                res = jacobi_solve_serial_sparse(
                    obj.jacobi_nb, rows_a, b, state.jacobi_past_x
                )
            else:
                from fem_tpu.solvers.dense import assemble_dense_system

                a_dense = assemble_dense_system(obj, K, dt, axis_name, beta)
                res = jacobi_solve_serial(a_dense, b, state.jacobi_past_x)
        elif jacobi_sweep == "snapshot":
            diag = diagonal_blocks(obj, K, dt, axis_name, beta)
            res = jacobi_solve(apply_a, diag, b, state.jacobi_past_x)
        else:
            raise ValueError(f"unknown jacobi_sweep {jacobi_sweep!r}")
        new_state = state.replace(vel=res.x, jacobi_past_x=res.past_x)
        return new_state, ImplicitAux(res.iterations, res.error)

    if method == CONJUGATE_GRADIENT_METHOD:
        def apply_at_fn():
            if use_mxu:
                return apply_at_mxu
            return make_system_apply_t(obj, K, dt, axis_name, beta)

        def two_level_fn_graph():
            from fem_tpu.solvers.multilevel import (
                coarse_matrix, make_coarse_space,
            )

            if obj.agg_ids is None:
                raise ValueError(
                    "cg_precond='two_level' needs the coarse space "
                    "attached at build time (models/state.build_object)"
                )
            coarse = make_coarse_space(obj)
            c = coarse_matrix(
                coarse, obj, K, dt, beta, obj.free_mask,
                axis_name=axis_name,
            )
            return coarse, c

        res = _cg_solve_dispatch(
            apply_a, apply_at_fn, b, preconditioned, cg_precond,
            lambda: diagonal_blocks(obj, K, dt, axis_name, beta),
            obj.mass,
            free=obj.free_mask,
            pin_vel=obj.pin_vel,
            two_level_fn=two_level_fn_graph,
        )
        return state.replace(vel=res.x), ImplicitAux(res.iterations, res.residual)

    raise ValueError(f"unknown implicit method {method}")
