# coding=utf-8
"""Two-level (coarse-space) preconditioner for the implicit operator.

Framework extension (``cg_precond="two_level"``) — the real preconditioner
the Newton integrator's large-dt regime calls for.  The implicit system
A = I − c·M⁻¹·G(K) (c = dt·(dt+β)) has the mass-symmetrized spectrum
[1, 1 + c·λmax/m]: its condition number grows like dt², so the Newton
integrator's large-dt selling point costs O(dt) inner CG iterations
(measured: 18-24 iters/substep at spot_real's stable dt, ~100 at the 68k
stability boundary).  Diagonal preconditioning cannot fix this (no
asymptotic cond gain for Laplacian-like operators — and at κ ≈ 1 it
measurably diverges); what does is the classic two-level
decomposition, measured on this operator's spectrum (round-5 probe):

* the TOP of the spectrum (element-scale stiff modes) is local →
  a damped block-Jacobi smoother damps it;
* the BOTTOM (smooth, low-energy deformations) is global → a coarse space
  of per-aggregate rigid-body modes captures it (probe: 0.5-1.0 overlap
  with the lowest eigenvectors on the flagship-class mesh).

Two cycles, both on the mass-symmetrized operator Ã = M^{1/2}AM^{-1/2}:

* ``cycle="multiplicative"`` (default) — the symmetric V-cycle

      x₁ = ω·D⁻¹·r;  x₂ = x₁ + R̃·C⁻¹·R̃ᵀ·(r − Ã·x₁);
      x₃ = x₂ + ω·D⁻¹·(r − Ã·x₂)

  3 fine applies per PCG iteration, but by far the strongest cut — the
  measured CPU ladder on a 2D mesh at 16/64/256× the reference dt:
  32/51/69 iterations vs plain CG's 160/442/500+(diverged), i.e. the
  apply-count break-even (3×) is cleared from ~64× dt upward and the
  advantage GROWS with dt (plain CG stops converging at all).  Needs
  ω·λmax(D⁻¹Ã) < 2 for SPD-ness; λmax is power-iterated at setup with a
  0.7 safety margin — an UNDER-estimated λmax over-relaxes the smoother,
  turns M indefinite, and stalls the outer Newton line search (a
  recorded static-slab failure).

* smoother ``"chebyshev"`` (``cg_precond="two_level_cheb<k>"``) — the
  degree-k Chebyshev polynomial sweep replaces the single damped-Jacobi
  sweep inside the multiplicative cycle, damping the whole
  [λmax/α, λmax] band of D⁻¹Ã instead of just its top.  This is the fix
  for the measured 3D weakness of the point smoother (λmax ≈ 5.8 in 3D
  vs ~2 in 2D): on the 3D static slab the Jacobi cycle cut NOTHING
  (3904 vs plain 3873 inner iters) while cheb3 cut 3.0× (1275).  Honest
  cost: 2k+1 fine applies per PCG iteration — plain CG keeps the 3D
  wall-clock crown at moderate sizes; the Chebyshev cycle owns the
  regimes where plain CG ramps past ~(2k+1)× or diverges.

* ``cycle="additive"`` — two-level additive Schwarz,
  M⁻¹·r = D⁻¹·r + R̃·C⁻¹·R̃ᵀ·r.  ZERO fine applies inside the
  preconditioner and SPD with no spectral estimate, but MEASURED WEAK:
  the non-overlapping block-Jacobi "local solves" leave the mid-spectrum
  uncovered, and past ~64× dt it stops converging where the V-cycle
  cruises (same ladder: 110/500+/500+ iterations).  Kept as the safe
  fallback where a spectral estimate is untrustworthy.

D is the (Gershgorin-shifted) symmetrized diagonal blocks, R̃ = M^{1/2}R
the aggregate rigid-body basis, and C = R̃ᵀÃR̃ assembled EXACTLY from the
per-element decoupled blocks in O(E) (the Laplacian scatter pattern makes
R̃ᵀG(K)R̃ a per-element 4-pair sum of 6×6 blocks) and dense-factored once
per setup — O((G·n_rb)³) ≪ solve cost for aggregate counts in the
hundreds.  :func:`two_level_setup` packages D⁻¹/R̃/the factor so callers
can build the preconditioner ONCE and reuse it across solves (the Newton
integrator freezes it per substep — preconditioner quality only, the
accepted solution contract never changes).

Intended regimes: large-dt backward Euler (Newton inner solves) and
quasi-static/heterogeneous systems.  At the κ ≈ 1 stability boundary the
system is near-indefinite and NO symmetrized-PCG process survives
(measured three ways) — that documented DON'T applies here
too.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from fem_tpu.models.state import FemObject
from fem_tpu.ops import smallmat as sm


def n_rigid_modes(dim: int) -> int:
    """Rigid-body modes per aggregate: translations + rotations."""
    return 3 if dim == 2 else 6


def parse_two_level_precond(name: str) -> Tuple[bool, str, int]:
    """Parse a ``cg_precond`` string into ``(is_two_level, smoother,
    degree)``.

    ``"two_level"`` selects the damped block-Jacobi smoother;
    ``"two_level_cheb<k>"`` (k in 2..6, e.g. ``"two_level_cheb3"``) selects
    the degree-k Chebyshev polynomial smoother — the fix for the measured
    3D weakness of the point smoother (λmax(D⁻¹Ã) ≈ 5.8 in 3D leaves the
    mid-spectrum undamped; a degree-k Chebyshev sweep damps the whole
    [λmax/α, λmax] band).  Any other name returns (False, "", 0)."""
    if name == "two_level":
        return True, "jacobi", 0
    if name.startswith("two_level_cheb"):
        tail = name[len("two_level_cheb"):]
        deg = int(tail) if tail else 3
        if not 2 <= deg <= 6:
            raise ValueError(
                f"two_level_cheb degree must be in 2..6, got {deg}"
            )
        return True, "chebyshev", deg
    return False, "", 0


def build_aggregates(
    rest_pos: np.ndarray, target_size: int = 96
) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side particle aggregation by Morton order over the rest
    positions (locality ⇒ aggregates are compact blobs, so their rigid
    modes approximate the smooth low-energy deformations).

    Returns ``(agg_ids (N,) int32, basis (N, d, n_rb) float32)`` — the
    per-particle rows of the rigid-body prolongator R, column-normalized
    per aggregate."""
    n, d = rest_pos.shape
    lo, hi = rest_pos.min(0), rest_pos.max(0)
    span = np.maximum(hi - lo, 1e-12)
    q = ((rest_pos - lo) / span * 1023).astype(np.uint64)

    def spread(v):
        v = v.astype(np.uint64)
        if d == 2:
            v = (v | (v << 16)) & np.uint64(0x0000FFFF0000FFFF)
            v = (v | (v << 8)) & np.uint64(0x00FF00FF00FF00FF)
            v = (v | (v << 4)) & np.uint64(0x0F0F0F0F0F0F0F0F)
            v = (v | (v << 2)) & np.uint64(0x3333333333333333)
            v = (v | (v << 1)) & np.uint64(0x5555555555555555)
            return v
        v = (v | (v << 32)) & np.uint64(0x1F00000000FFFF)
        v = (v | (v << 16)) & np.uint64(0x1F0000FF0000FF)
        v = (v | (v << 8)) & np.uint64(0x100F00F00F00F00F)
        v = (v | (v << 4)) & np.uint64(0x10C30C30C30C30C3)
        v = (v | (v << 2)) & np.uint64(0x1249249249249249)
        return v

    code = spread(q[:, 0])
    for ax in range(1, d):
        code |= spread(q[:, ax]) << np.uint64(ax)
    order = np.argsort(code, kind="stable")
    n_agg = max(1, int(round(n / target_size)))
    agg = np.zeros(n, np.int32)
    bounds = np.linspace(0, n, n_agg + 1).astype(int)
    for g in range(n_agg):
        agg[order[bounds[g]:bounds[g + 1]]] = g

    nrb = n_rigid_modes(d)
    basis = np.zeros((n, d, nrb), np.float32)
    for g in range(n_agg):
        sel = np.where(agg == g)[0]
        c = rest_pos[sel].mean(0)
        rel = rest_pos[sel] - c
        b = np.zeros((sel.size, d, nrb), np.float64)
        for ax in range(d):  # translations
            b[:, ax, ax] = 1.0
        if d == 2:  # one in-plane rotation
            b[:, 0, 2] = -rel[:, 1]
            b[:, 1, 2] = rel[:, 0]
        else:  # three rotations r_k = e_k × (x − c)
            b[:, 1, 3] = -rel[:, 2]
            b[:, 2, 3] = rel[:, 1]
            b[:, 0, 4] = rel[:, 2]
            b[:, 2, 4] = -rel[:, 0]
            b[:, 0, 5] = -rel[:, 1]
            b[:, 1, 5] = rel[:, 0]
        # Column normalization (degenerate rotation columns of tiny
        # aggregates stay ~0 and are handled by the ridge in the factor).
        nrm = np.sqrt((b * b).sum(axis=(0, 1)))
        b /= np.maximum(nrm, 1e-12)[None, None, :]
        basis[sel] = b.astype(np.float32)
    return agg, basis


class CoarseSpace(NamedTuple):
    """Device-side aggregate data (attached to FemObject at build time:
    ``agg_ids`` / ``agg_basis`` / ``num_aggregates``)."""

    agg_ids: jnp.ndarray  # (N,) int32
    basis: jnp.ndarray  # (N, d, n_rb) float32
    num_aggregates: int


def default_aggregate_size(dim: int) -> int:
    """Aggregate granularity: ~3 elements across (measured sweet spot — the
    2D sweep showed size-10 aggregates beating size-24 by 1.5-9x in
    iterations and staying robust as dt grows)."""
    return 10 if dim == 2 else 40


def make_coarse_space(
    obj: FemObject, target_size: int | None = None
) -> CoarseSpace:
    if obj.agg_ids is not None and target_size is None:
        return CoarseSpace(
            agg_ids=obj.agg_ids, basis=obj.agg_basis,
            num_aggregates=obj.num_aggregates,
        )
    if target_size is None:
        target_size = default_aggregate_size(obj.dim)
    agg, basis = build_aggregates(np.asarray(obj.rest_pos), target_size)
    return CoarseSpace(
        agg_ids=jnp.asarray(agg),
        basis=jnp.asarray(basis),
        num_aggregates=int(agg.max()) + 1,
    )


def coarse_matrix(
    coarse: CoarseSpace,
    obj: FemObject,
    K: jnp.ndarray,  # (E, d, d) decoupled blocks on ``element_indices``
    dt: float,
    beta: float = 0.0,
    free_mask: jnp.ndarray | None = None,
    element_indices: jnp.ndarray | None = None,
    axis_name: str | None = None,
    coeff: jnp.ndarray | float | None = None,
    mass_vec: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """C = R̃ᵀÃR̃ (G·n_rb, G·n_rb) assembled exactly in O(E).

    Generalized form C = Rᵀ·diag(mass_vec)·R − coeff·RᵀG(K)R: the dynamic
    system uses the defaults (mass_vec = obj.mass, coeff = dt·(dt+β)); the
    quasi-static solver passes coeff = 1 (its operator is H + λI with
    H = −G(K)) and mass_vec = λ·ones (the Levenberg shift).

    Derivation: for x = R y, the graph-Laplacian quadratic form is
    xᵀG(K)x = Σ_e Σ_j s_jᵀ·K_e·s_j with s_j = x_{v_{j+1}} − x_{v_0}, so
    with per-vertex basis rows T_i = basis[v_i] (d, n_rb) each element
    contributes, per edge j, the four aggregate-pair blocks
    (g_j,g_j,+T_jᵀKT_j), (g_j,g_0,−T_jᵀKT_0), (g_0,g_j,−T_0ᵀKT_j),
    (g_0,g_0,+T_0ᵀKT_0).  The mass term R̃ᵀR̃ = RᵀMR is aggregate-block-
    diagonal.  ``free_mask`` zeroes pinned particles' basis rows, which
    assembles the Dirichlet-projected coarse operator exactly (pinned
    rows never enter any pair)."""
    d, n = obj.dim, obj.particle_cnt
    nrb = n_rigid_modes(d)
    g_count = coarse.num_aggregates
    hp = jax.lax.Precision.HIGHEST
    basis = coarse.basis
    if free_mask is not None:
        basis = basis * free_mask[..., None]
    # K may live on a different element array than obj.element_indices
    # (zero-volume padded elements carry K = 0 so they contribute
    # nothing).
    idx = (
        obj.element_indices if element_indices is None else element_indices
    )  # (E, d+1)
    e = idx.shape[0]
    t = basis[idx]  # (E, d+1, d, n_rb)
    g = coarse.agg_ids[idx]  # (E, d+1)
    t0, tj = t[:, 0], t[:, 1:]  # (E, d, nrb), (E, d_edges, d, nrb)
    g0, gj = g[:, 0], g[:, 1:]
    kt0 = jnp.einsum("eab,ebr->ear", K, t0, precision=hp)  # K·T_0
    ktj = jnp.einsum("eab,ejbr->ejar", K, tj, precision=hp)  # K·T_j
    # Four pair-blocks per edge: rows stack as (E, d_edges, 4, nrb, nrb).
    p_jj = jnp.einsum("ejas,ejar->ejsr", tj, ktj, precision=hp)
    p_j0 = -jnp.einsum("ejas,ear->ejsr", tj, kt0, precision=hp)
    p_0j = -jnp.einsum("eas,ejar->ejsr", t0, ktj, precision=hp)
    # One +T_0ᵀKT_0 per edge (the Σ_j expansion gives the reference's d·K
    # at (v_0, v_0) — solver/implicit.py:168).
    p_00 = jnp.einsum("eas,ear->esr", t0, kt0, precision=hp)
    pair_blocks = jnp.concatenate(
        [
            p_jj.reshape(e * d, nrb * nrb),
            p_j0.reshape(e * d, nrb * nrb),
            p_0j.reshape(e * d, nrb * nrb),
            jnp.tile(p_00.reshape(e, 1, nrb * nrb), (1, d, 1)).reshape(
                e * d, nrb * nrb
            ),
        ],
        axis=0,
    )
    g0e = jnp.tile(g0[:, None], (1, d)).reshape(-1)
    gje = gj.reshape(-1)
    pair_ids = jnp.concatenate(
        [
            gje * g_count + gje,
            gje * g_count + g0e,
            g0e * g_count + gje,
            g0e * g_count + g0e,
        ]
    )
    gkr = jax.ops.segment_sum(
        pair_blocks, pair_ids, num_segments=g_count * g_count
    )
    if axis_name is not None:  # per-shard element slices -> full pair sum
        gkr = jax.lax.psum(gkr, axis_name)
    gkr = gkr.reshape(g_count, g_count, nrb, nrb)
    if coeff is None:
        coeff = dt * (dt + beta)
    if mass_vec is None:
        mass_vec = obj.mass
    # Mass (identity) term: block-diagonal RᵀMR.
    mb = jnp.einsum(
        "nas,nar->nsr", basis, basis * mass_vec[:, None, None],
        precision=hp,
    )
    mass_diag = jax.ops.segment_sum(
        mb.reshape(n, nrb * nrb), coarse.agg_ids,
        num_segments=g_count,
    ).reshape(g_count, nrb, nrb)
    c = -coeff * gkr
    c = c.at[jnp.arange(g_count), jnp.arange(g_count)].add(mass_diag)
    c_dense = c.transpose(0, 2, 1, 3).reshape(
        g_count * nrb, g_count * nrb
    )
    # Symmetrize: the decoupled element blocks K_e are individually
    # nonsymmetric (exactly like the fine operator, whose PCG runs on the
    # symmetrized form — solvers/implicit.preconditioned_conjugate_
    # gradient), and an unsymmetrized C NaNs the Cholesky factor.
    c_dense = 0.5 * (c_dense + c_dense.T)
    # Ridge: keeps degenerate coarse columns (fully-pinned or single-point
    # aggregates) harmless without touching well-posed ones.
    ridge = 1e-6 * jnp.trace(c_dense) / c_dense.shape[0]
    return c_dense + ridge * jnp.eye(c_dense.shape[0], dtype=c_dense.dtype)


def static_diag_blocks(
    obj: FemObject,
    K: jnp.ndarray,  # (E, d, d) decoupled blocks (hessian_blocks)
    lam: jnp.ndarray,  # Levenberg shift (scalar)
) -> jnp.ndarray:
    """Per-particle diagonal blocks of the STATIC operator H + λ·I with
    H = −G(K): local vertex 0 receives d·K, vertices 1..d receive K
    (the same weights as solvers/implicit.diagonal_blocks, without the
    dynamic I − c·M⁻¹ scaling)."""
    d, n = obj.dim, obj.particle_cnt
    w = jnp.concatenate(
        [jnp.full((K.shape[0], 1), float(d)), jnp.ones((K.shape[0], d))],
        axis=1,
    )
    contrib = w[..., None] * K.reshape(K.shape[0], 1, d * d)
    diag_k = jax.ops.segment_sum(
        contrib.reshape(-1, d * d), obj.element_indices.reshape(-1),
        num_segments=n,
    ).reshape(n, d, d)
    eye = jnp.eye(d, dtype=K.dtype)[None]
    return lam * eye - diag_k


class CGResult(NamedTuple):
    x: jnp.ndarray
    iterations: jnp.ndarray
    residual: jnp.ndarray


class TwoLevelSetup(NamedTuple):
    """Prebuilt two-level preconditioner pieces (symmetrized space): the
    Gershgorin-shifted smoother inverse, R̃ rows, and the equilibrated
    Cholesky factor of C.  Build once with :func:`two_level_setup`, reuse
    across solves (frozen-preconditioner pattern — quality only)."""

    minv: jnp.ndarray  # (N, d, d)
    basis_t: jnp.ndarray  # (N, d, n_rb)
    agg_ids: jnp.ndarray  # (N,)
    num_aggregates: int
    dscale: jnp.ndarray  # (G·n_rb,)
    chol_l: jnp.ndarray  # (G·n_rb, G·n_rb) lower factor
    chol_ok: jnp.ndarray  # scalar bool
    sq: jnp.ndarray  # (N, 1) sqrt mass
    omega: jnp.ndarray | None = None  # smoother damping (multiplicative)
    lam_max: jnp.ndarray | None = None  # power-iterated λmax(D⁻¹Ã)


def _vdot(a, b):
    return jnp.sum(a * b)


def estimate_lam_max(
    smooth_apply: Callable[[jnp.ndarray], jnp.ndarray],
    op: Callable[[jnp.ndarray], jnp.ndarray],
    shape_like: jnp.ndarray,
    iters: int = 16,
) -> jnp.ndarray:
    """λmax(D⁻¹Ã) by power iteration.  The start vector is deliberately
    ROUGH (alternating-sign, irrational stride) because λmax's eigenvector
    is element-scale oscillatory and a smooth start (all-ones) overlaps it
    only through roundoff — 16 iterations from it land within a few % on
    this operator family.  Estimate on the SAME operator the cycle uses
    (a recorded static-slab stall: a ~30% λmax miss from a softer
    surrogate operator over-relaxed the smoother and turned M indefinite)."""
    n = shape_like.size
    rough = jnp.sin(
        (1.0 + jnp.arange(n, dtype=jnp.float32)) * 2.399963
    ).reshape(shape_like.shape)
    v = smooth_apply(rough)
    lam = jnp.float32(1.0)
    for _ in range(iters):
        w = smooth_apply(op(v))
        lam = jnp.sqrt(_vdot(w, w)) / jnp.maximum(
            jnp.sqrt(_vdot(v, v)), 1e-30
        )
        v = w / jnp.maximum(jnp.sqrt(_vdot(w, w)), 1e-30)
    return jnp.maximum(lam, 1e-6)


def estimate_omega(
    smooth_apply: Callable[[jnp.ndarray], jnp.ndarray],
    op: Callable[[jnp.ndarray], jnp.ndarray],
    shape_like: jnp.ndarray,
    iters: int = 16,
    safety: float = 0.9,
) -> jnp.ndarray:
    """ω = safety / λmax(D⁻¹Ã).  SPD-ness of the damped-Jacobi V-cycle
    needs ω·λmax < 2, so the fatal direction is an UNDER-estimate of λmax;
    the rough-start power iteration plus the 0.9 safety absorbs the
    few-percent estimation error (see :func:`estimate_lam_max`)."""
    return safety / estimate_lam_max(smooth_apply, op, shape_like, iters)


def two_level_setup(
    diag: jnp.ndarray,  # (N, d, d) diagonal blocks of A
    mass: jnp.ndarray,  # (N,)
    coarse: CoarseSpace,
    c_matrix: jnp.ndarray,  # coarse_matrix output
    free_mask: jnp.ndarray | None = None,
    operator: Callable[[jnp.ndarray], jnp.ndarray] | None = None,
) -> TwoLevelSetup:
    """Assemble the reusable preconditioner pieces (one Cholesky).  Pass
    ``operator`` (A in the ORIGINAL space) to also power-iterate the
    smoother damping ω here — hoisting the 12 operator applies out of
    every solve that reuses this setup."""
    d = diag.shape[-1]
    sq = jnp.sqrt(mass)[:, None]
    basis = coarse.basis
    if free_mask is not None:
        basis = basis * free_mask[..., None]
    # Symmetrized-space basis rows: R̃ = M^{1/2} R.
    basis_t = basis * sq[..., None]

    # Safe smoother diag: per-block Gershgorin SPD SHIFT (not the
    # block-Jacobi trust-test flatten-to-identity — that made ~7% of a
    # healthy large-dt mesh's blocks artificially weak, raised
    # λmax(D⁻¹Ã) 1.78→2.36 and cost 4× in iterations).  Blocks already
    # diagonally dominant with margin are untouched.
    dsym = 0.5 * (diag + sm.mT(diag))
    absdiag = jnp.abs(jnp.diagonal(dsym, axis1=-2, axis2=-1))
    offdiag = jnp.sum(jnp.abs(dsym), axis=-1) - absdiag
    gersh_min = jnp.min(
        jnp.diagonal(dsym, axis1=-2, axis2=-1) - offdiag, axis=-1
    )
    scale = jnp.mean(absdiag, axis=-1) + 1e-30
    shift_b = jnp.maximum(0.0, 0.01 * scale - gersh_min)
    eye = jnp.eye(d, dtype=diag.dtype)[None]
    minv = sm.inv(dsym + shift_b[:, None, None] * eye)

    # Jacobi-equilibrate before the f32 Cholesky (cond(C) grows with dt² —
    # measured 1e4+ at the interesting dt; equilibration + the symmetrized
    # assembly keep the f32 factor accurate to ~1e-3, enough for a
    # preconditioner).
    dscale = 1.0 / jnp.sqrt(
        jnp.maximum(jnp.diagonal(c_matrix), 1e-20)
    )
    c_eq = c_matrix * dscale[:, None] * dscale[None, :]
    # SPD guard ladder: under compression/near-buckling the decoupled
    # blocks go indefinite and C inherits it — an unguarded Cholesky then
    # NaNs, and a NaN preconditioner silently skips every elastic solve
    # (the measured κ≈1 block-Jacobi failure mode).
    #   1. plain factor (healthy regimes: bit-identical, Gershgorin would
    #      over-shift a coarse Laplacian's non-dominant rotation rows);
    #   2. Gershgorin-shifted factor (certified SPD, conservative);
    #   3. no coarse correction at all (smoother-only PCG — never NaN).
    # The fallback factor runs under lax.cond — healthy regimes (the
    # common case) pay for ONE Cholesky, not two.
    eye_c = jnp.eye(c_eq.shape[0], dtype=c_eq.dtype)
    chol0 = jnp.linalg.cholesky(c_eq)
    ok0 = jnp.isfinite(chol0).all()

    def _keep(_):
        return jnp.where(ok0, chol0, eye_c), ok0

    def _fallback(_):
        row_abs = jnp.sum(jnp.abs(c_eq), axis=1) - jnp.abs(
            jnp.diagonal(c_eq)
        )
        shift = (
            jnp.maximum(0.0, jnp.max(row_abs - jnp.diagonal(c_eq))) + 1e-6
        )
        chol1 = jnp.linalg.cholesky(c_eq + shift * eye_c)
        ok1 = jnp.isfinite(chol1).all()
        return jnp.where(ok1, chol1, eye_c), ok1

    chol_l, chol_ok = jax.lax.cond(ok0, _keep, _fallback, None)
    omega = None
    lam_max = None
    if operator is not None:
        hp = jax.lax.Precision.HIGHEST

        def _smooth(r):
            return jnp.einsum("nij,nj->ni", minv, r, precision=hp)

        def _op_sym(y):
            return sq * operator(y / sq)

        lam_max = estimate_lam_max(_smooth, _op_sym, basis[..., 0])
        omega = 0.9 / lam_max
    return TwoLevelSetup(
        minv=minv, basis_t=basis_t, agg_ids=coarse.agg_ids,
        num_aggregates=coarse.num_aggregates, dscale=dscale,
        chol_l=chol_l, chol_ok=chol_ok, sq=sq, omega=omega,
        lam_max=lam_max,
    )


def two_level_pcg(
    operator: Callable[[jnp.ndarray], jnp.ndarray],  # A (original space)
    diag: jnp.ndarray | None,  # (N, d, d) diagonal blocks of A
    mass: jnp.ndarray,  # (N,)
    coarse: CoarseSpace | None,
    c_matrix: jnp.ndarray | None,  # coarse_matrix output
    rhs: jnp.ndarray,
    x0: jnp.ndarray,
    max_iter: int = 500,
    tol: float = 1e-5,
    omega: float | None = None,
    free_mask: jnp.ndarray | None = None,
    precond_operator: Callable[[jnp.ndarray], jnp.ndarray] | None = None,
    setup: TwoLevelSetup | None = None,
    cycle: str = "multiplicative",
    smoother: str = "jacobi",
    cheb_degree: int = 3,
    cheb_alpha: float = 8.0,
) -> CGResult:
    """PCG on the mass-symmetrized operator with the two-level
    preconditioner (symmetric V-cycle by default; additive Schwarz with
    ``cycle="additive"``).  Termination stays the reference's
    ABSOLUTE rᵀr ≤ tol on the ORIGINAL residual (interchangeable
    solutions — same contract as solvers/implicit.preconditioned_
    conjugate_gradient).  Pass ``setup`` (from :func:`two_level_setup`)
    to reuse a frozen preconditioner across solves; otherwise
    ``diag``/``coarse``/``c_matrix`` are assembled here.

    ``smoother="chebyshev"`` (multiplicative cycle only) replaces the
    single damped-Jacobi sweep with a degree-``cheb_degree`` Chebyshev
    polynomial sweep targeting the band [λmax/``cheb_alpha``, λmax] of
    D⁻¹Ã — the textbook fix for the point smoother's measured 3D weakness
    (λmax ≈ 5.8 leaves the mid-spectrum barely damped: |1 − ωλ| ≈ 0.5-0.85
    for λ ∈ [1, 3], while Chebyshev(3) holds the whole band under ~0.1).
    Cost model: 2·k fine applies per PCG iteration (vs the Jacobi cycle's
    2), so it wins wall-clock only where the iteration cut exceeds
    ~(2k+1)/3.  SPD-ness needs the band's upper edge ≥ the true λmax; the
    power-iterated estimate is inflated 1.1× (an over-estimate only
    weakens the sweep, an under-estimate can turn M indefinite — same
    failure direction as the Jacobi ω)."""
    if cycle not in ("additive", "multiplicative"):
        raise ValueError(f"unknown two-level cycle {cycle!r}")
    if smoother not in ("jacobi", "chebyshev"):
        raise ValueError(f"unknown two-level smoother {smoother!r}")
    if smoother == "chebyshev" and cycle != "multiplicative":
        raise ValueError(
            "smoother='chebyshev' requires the multiplicative cycle"
        )
    hp = jax.lax.Precision.HIGHEST
    if setup is None:
        setup = two_level_setup(diag, mass, coarse, c_matrix, free_mask)
    minv, basis_t, sq = setup.minv, setup.basis_t, setup.sq
    nrb = basis_t.shape[-1]
    g_count = setup.num_aggregates

    def op(y):  # Ã in the symmetrized space
        return sq * operator(y / sq)

    # The V-cycle's internal residual updates may run on a CHEAPER
    # approximation of A (e.g. the decoupled operator while CG iterates the
    # exact HVP) — M stays SPD as long as the approximation is; only
    # preconditioner quality changes, never the accepted solution.
    if precond_operator is None:
        op_m = op
    else:
        def op_m(y):
            return sq * precond_operator(y / sq)

    def smooth_apply(r):
        return jnp.einsum("nij,nj->ni", minv, r, precision=hp)

    def coarse_apply(r):
        ry = jax.ops.segment_sum(
            jnp.einsum("nar,na->nr", basis_t, r, precision=hp),
            setup.agg_ids, num_segments=g_count,
        ).reshape(-1)
        y = setup.dscale * jax.scipy.linalg.cho_solve(
            (setup.chol_l, True), setup.dscale * ry
        )
        y = jnp.where(setup.chol_ok, y, 0.0).reshape(g_count, nrb)
        return jnp.einsum(
            "nar,nr->na", basis_t, y[setup.agg_ids], precision=hp
        )

    if cycle == "additive":
        # M⁻¹ = ω·D⁻¹ + R̃C⁻¹R̃ᵀ — SPD for any ω > 0 (no spectral
        # estimate), zero fine-operator applies inside the preconditioner.
        omega_t = jnp.float32(1.0 if omega is None else omega)

        def apply_m(r):
            return omega_t * smooth_apply(r) + coarse_apply(r)

    elif smoother == "chebyshev":
        # Degree-k Chebyshev sweeps around the coarse correction.  The
        # smoother's error operator is a fixed polynomial q_k(D⁻¹Ã) with
        # q_k(0) = 1, |q_k| ≤ 1/T_k(σ) on [lb, ub] and q_k ∈ (0, 1) on
        # (0, lb) — self-adjoint in the Ã inner product, so the symmetric
        # pre/post arrangement keeps M SPD as long as ub ≥ λmax.
        if setup.lam_max is not None:
            lam = setup.lam_max
        else:
            lam = estimate_lam_max(smooth_apply, op_m, rhs)
        ub = 1.1 * lam  # over-estimate: weakens the sweep, never breaks SPD
        lb = ub / jnp.float32(cheb_alpha)
        theta = 0.5 * (ub + lb)
        delta = 0.5 * (ub - lb)
        sigma = theta / delta

        def cheb_sweep(x0, r0, need_r):
            """k-step Chebyshev iteration on Ã x = b from (x0, r0 = b −
            Ã x0); returns (x, r) with r exact for the returned x when
            ``need_r`` (k op_m applies; k−1 when the caller discards r)."""
            rho = 1.0 / sigma
            d = smooth_apply(r0) / theta
            x, r = x0, r0
            for _ in range(cheb_degree - 1):
                x = x + d
                r = r - op_m(d)
                rho_next = 1.0 / (2.0 * sigma - rho)
                d = (rho_next * rho) * d + (
                    2.0 * rho_next / delta
                ) * smooth_apply(r)
                rho = rho_next
            return x + d, (r - op_m(d)) if need_r else r

        def apply_m(r):
            x1, r1 = cheb_sweep(jnp.zeros_like(r), r, True)  # pre-smooth
            e = coarse_apply(r1)
            x2 = x1 + e
            r2 = r1 - op_m(e)
            x3, _ = cheb_sweep(x2, r2, False)  # post-smooth (same poly)
            return x3

    else:
        if omega is not None:
            omega_t = jnp.float32(omega)
        elif setup.omega is not None:
            omega_t = setup.omega  # hoisted estimate (two_level_setup)
        else:
            # Power-iterate λmax(D⁻¹Ã) once per solve and damp below it —
            # the symmetric V-cycle is SPD only for ω·λmax < 2 (see
            # estimate_omega for the safety-margin rationale).  Prefer
            # hoisting this into two_level_setup when the setup is reused.
            omega_t = estimate_omega(smooth_apply, op_m, rhs)

        def apply_m(r):
            x1 = omega_t * smooth_apply(r)
            r1 = r - op_m(x1)
            x2 = x1 + coarse_apply(r1)
            r2 = r - op_m(x2)
            return x2 + omega_t * smooth_apply(r2)

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
        y, r, p, delta, _, it = c
        q = op(p)
        alpha = delta / _vdot(p, q)
        y = y + alpha * p
        r = r - alpha * q
        z = apply_m(r)
        delta_next = _vdot(r, z)
        p = z + (delta_next / delta) * p
        return (y, r, p, delta_next, rr_orig(r), it + 1)

    y, _, _, _, rr, it = jax.lax.while_loop(cond, body, carry0)
    return CGResult(x=y / sq, iterations=it, residual=rr)
