# coding=utf-8
"""Inelastic material extensions: multiplicative plasticity + viscoelasticity.

Framework extensions (the reference is purely hyperelastic — its entire
material surface is the Neo-Hookean energy/force pair,
solver/explicit.py:23-28).  Both models use per-element internal variables
carried on the state pytree and updated ONCE per substep from the
end-of-substep positions (explicit treatment of internal variables —
standard operator splitting; the elastic solve within a substep sees them
frozen):

* **Von-Mises multiplicative plasticity** (``ObjectConfig.plastic_yield``):
  F = F_e·F_p with the BASE material evaluated on F_e = F·F_p⁻¹ — realized
  by running the unchanged element chain on the *effective* rest-edge
  inverse ``ref_inv·F_p⁻¹`` (F = X·R⁻¹ ⇒ F_e = X·(R⁻¹F_p⁻¹), and the
  force chain's trailing ·R⁻ᵀ becomes ·(R⁻¹F_p⁻¹)ᵀ by the same chain
  rule).  The return map acts on principal Hencky strains: SVD
  F_e = U·Σ·Vᵀ, ε = log Σ; if ‖dev ε‖ > ε_y, scale the deviator back onto
  the yield surface (radial return, perfect plasticity).  The volumetric
  part never flows → det F_p = 1 exactly (isochoric flow), so rest volumes
  and lumped masses stay valid.

* **Generalized-Maxwell viscoelasticity** (``viscous_mu``/``viscous_tau``):
  one Maxwell branch adds a stable-Neo-Hookean stress (λ = 0) with shear
  modulus μ_v evaluated on the branch strain F·F_v⁻¹; each substep the
  branch's principal log strain decays by exp(−dt/τ) (the exact solution
  of the linearized Maxwell ODE per step).  dt ≪ τ gives rubber-like
  transient stiffness μ + μ_v; t ≫ τ relaxes to the base material —
  stress relaxation and creep fall out.

Execution: inelastic stress is exposed as *material layers*
(:func:`material_layers`) — (internal inverse, μ, λ, material) tuples whose
contributions sum — and every implicit/explicit/Newton execution path
consumes them by composing the layer's dynamic ``F_i⁻¹`` with its own
rest-edge inverses: the graph and mxu operators, Newton's decoupled mode,
and the sharded path (internal variables replicated; updates shard-local +
all_gather).  Differentiable stepping traces the yield strain
(fem_tpu/diff.py DiffParams).  The return map is SVD-free — a Jacobi
``sym_eigh`` on C = FᵀF (ops/smallmat.py), elementwise arithmetic with no
batched linear-algebra library call.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from fem_tpu.models.state import FemObject, SimState
from fem_tpu.ops import smallmat as sm
from fem_tpu.ops.assembly import assemble_for, element_contrib_full
from fem_tpu.ops.element import (
    deformation_gradients,
    energy_density,
    explicit_grad_columns,
)

# The Maxwell branch's functional form: polynomial (inversion-finite),
# rest-stable, with DP(I) matching linear elasticity — the robust choice
# for a strain that is continually reset toward I by relaxation.
_BRANCH_MATERIAL = "stable_neo_hookean"


def is_inelastic(obj: FemObject) -> bool:
    return obj.plastic_yield > 0.0 or obj.viscous_mu > 0.0


def effective_ref_inv(
    ref_inv: jnp.ndarray, fi_inv: jnp.ndarray | None
) -> jnp.ndarray:
    """R⁻¹·F_i⁻¹ — the effective rest-edge inverse that makes the unchanged
    element chain compute forces of φ(F·F_i⁻¹)."""
    if fi_inv is None:
        return ref_inv
    return sm.matmul_ew(ref_inv, fi_inv)


def material_layers(obj: FemObject, state: SimState) -> tuple:
    """Material layers ``(fi_inv, mu, lam, material)`` whose force / Hessian
    contributions SUM to the full (in)elastic stress: the base material
    evaluated on the effective rest-edge inverse ``ref_inv·F_p⁻¹``, plus the
    optional generalized-Maxwell branch on ``ref_inv·F_v⁻¹``.

    ``fi_inv`` is the per-element internal inverse in MESH element order
    (``None`` means the static ``ref_inv`` — the pure elastic layer).  This
    is the interface that threads inelasticity through every implicit /
    explicit / Newton execution path: consumers compose ``fi_inv`` with the
    (possibly shard-local) rest-edge inverses they hold via
    :func:`layer_ref_inv_local`."""
    layers = [(state.plastic_inv, obj.mu, obj.s_lambda, obj.material)]
    if state.viscous_inv is not None:
        layers.append(
            (state.viscous_inv, obj.viscous_mu, 0.0, _BRANCH_MATERIAL)
        )
    return tuple(layers)


def layer_ref_inv_local(
    ref_inv: jnp.ndarray,
    fi_inv: jnp.ndarray | None,
    axis_name: str | None = None,
) -> jnp.ndarray:
    """Effective rest-edge inverse for one material layer, in the element
    order of ``ref_inv``.  Under ``shard_map`` (``axis_name``) the internal
    variables are REPLICATED over the full padded element range while
    ``ref_inv`` is this shard's contiguous slice — shards slice their rows
    by ``axis_index`` (fem_tpu.parallel.sharding's contiguous layout)."""
    if fi_inv is None:
        return ref_inv
    if axis_name is not None and fi_inv.shape[0] != ref_inv.shape[0]:
        e_local = ref_inv.shape[0]
        start = jax.lax.axis_index(axis_name) * e_local
        fi_inv = jax.lax.dynamic_slice_in_dim(fi_inv, start, e_local, 0)
    return sm.matmul_ew(ref_inv, fi_inv)


def _log_strain(F: jnp.ndarray):
    """Principal log strains of a batch of (E, d, d) matrices WITHOUT an SVD:
    Jacobi eigendecomposition of C = FᵀF = V·diag(σ²)·Vᵀ (pure elementwise
    math that fuses with its neighbours, where a batched
    ``jnp.linalg.svd`` would be a separate library call per substep).
    Returns (ε, V) with
    singular values clamped away from zero so an (inverted/collapsed)
    element yields finite strains instead of NaNs."""
    c = sm.gram(F)
    w, v = sm.sym_eigh(c)
    s = jnp.sqrt(jnp.maximum(w, 1e-12))
    return jnp.log(jnp.maximum(s, 1e-6)), v


def _principal_rescale(F: jnp.ndarray, delta_eps: jnp.ndarray, v: jnp.ndarray):
    """F with its principal stretches multiplied by exp(Δε): with
    F = U·Σ·Vᵀ, U·Σ·exp(Δε)·Vᵀ = F·(V·diag(exp Δε)·Vᵀ) — no U needed, and
    Δε = 0 rows return F to roundoff (no SVD roundtrip error)."""
    m = sm.matmul_ew(v * jnp.exp(delta_eps)[..., None, :], sm.mT(v))
    return sm.matmul_ew(F, m)


def plastic_return_map(
    fe_trial: jnp.ndarray, yield_eps: float
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Radial return in principal Hencky-strain space (perfect plasticity,
    isochoric flow).  Returns (F_e projected onto the yield surface,
    yielded mask (E,))."""
    eps, v = _log_strain(fe_trial)
    mean = jnp.mean(eps, axis=-1, keepdims=True)
    dev = eps - mean
    nrm = jnp.sqrt(jnp.sum(dev * dev, axis=-1, keepdims=True))
    yielded = nrm[..., 0] > yield_eps
    scale = jnp.where(
        nrm > yield_eps, yield_eps / jnp.maximum(nrm, 1e-30), 1.0
    )
    fe_new = _principal_rescale(fe_trial, dev * (scale - 1.0), v)
    return fe_new, yielded


def viscous_relax(fbe_trial: jnp.ndarray, dt: float, tau: float) -> jnp.ndarray:
    """Branch strain after one substep of Maxwell relaxation: principal log
    strains decay by exp(−dt/τ)."""
    eps, v = _log_strain(fbe_trial)
    return _principal_rescale(fbe_trial, eps * (jnp.exp(-dt / tau) - 1.0), v)


def advance_internal(
    obj: FemObject, state: SimState, dt: float,
    axis_name: str | None = None,
) -> SimState:
    """Update the per-element internal variables from the (end-of-substep)
    positions in ``state``.  Elements with non-positive det F freeze their
    internal state for the step (an inverted element has no meaningful
    polar sector; the elastic layer owns recovery).

    Under ``shard_map`` (``axis_name``) the internal variables are replicated
    over the full padded element range while ``obj`` holds this shard's
    contiguous element slice: each shard updates its own rows (purely
    per-element math, no collectives in the chain) and one ``all_gather``
    reassembles the replicated arrays — the updates are deterministic, so
    every shard holds identical copies afterwards."""
    if not is_inelastic(obj):
        return state
    e_local = obj.element_indices.shape[0]

    def local_rows(full: jnp.ndarray) -> jnp.ndarray:
        if axis_name is None or full.shape[0] == e_local:
            return full
        start = jax.lax.axis_index(axis_name) * e_local
        return jax.lax.dynamic_slice_in_dim(full, start, e_local, 0)

    def regather(local: jnp.ndarray, full: jnp.ndarray) -> jnp.ndarray:
        if axis_name is None or full.shape[0] == e_local:
            return local
        return jax.lax.all_gather(local, axis_name, tiled=True)

    F = deformation_gradients(state.pos, obj.element_indices, obj.ref_inv)
    ok = (sm.det(F) > 1e-9)[..., None, None]
    # A guarded inverse so frozen (inverted) elements never see NaNs.
    f_safe = jnp.where(ok, F, jnp.broadcast_to(jnp.eye(obj.dim), F.shape))
    f_inv = sm.inv(f_safe)
    new = {}
    if state.plastic_inv is not None:
        p_inv = local_rows(state.plastic_inv)
        fe_trial = sm.matmul_ew(F, p_inv)
        fe_new, yielded = plastic_return_map(fe_trial, obj.plastic_yield)
        fp_inv_new = sm.matmul_ew(f_inv, fe_new)
        upd = ok & yielded[..., None, None]
        new["plastic_inv"] = regather(
            jnp.where(upd, fp_inv_new, p_inv), state.plastic_inv
        )
    if state.viscous_inv is not None:
        v_inv = local_rows(state.viscous_inv)
        fbe_trial = sm.matmul_ew(F, v_inv)
        fbe_new = viscous_relax(fbe_trial, dt, obj.viscous_tau)
        fv_inv_new = sm.matmul_ew(f_inv, fbe_new)
        new["viscous_inv"] = regather(
            jnp.where(ok, fv_inv_new, v_inv), state.viscous_inv
        )
    return state.replace(**new)


def inelastic_grad_columns(
    obj: FemObject, state: SimState, pos: jnp.ndarray
) -> jnp.ndarray:
    """Energy-gradient columns (E, d, d) of the full inelastic stress: base
    material on F_e = F·F_p⁻¹ plus the Maxwell branch on F·F_v⁻¹ (reference
    gradient sign convention — added to ``particles.force``)."""
    r_base = effective_ref_inv(obj.ref_inv, state.plastic_inv)
    cols = explicit_grad_columns(
        pos, obj.element_indices, r_base, obj.volume,
        obj.mu, obj.s_lambda, obj.material,
    )
    if state.viscous_inv is not None:
        r_branch = effective_ref_inv(obj.ref_inv, state.viscous_inv)
        cols = cols + explicit_grad_columns(
            pos, obj.element_indices, r_branch, obj.volume,
            obj.viscous_mu, 0.0, _BRANCH_MATERIAL,
        )
    return cols


def inelastic_energy_gradient(
    obj: FemObject, state: SimState, pos: jnp.ndarray,
    axis_name: str | None = None,
) -> jnp.ndarray:
    cols = inelastic_grad_columns(obj, state, pos)
    return assemble_for(obj, element_contrib_full(cols), axis_name)


def inelastic_element_energies(
    obj: FemObject, state: SimState, pos: jnp.ndarray
) -> jnp.ndarray:
    """Per-element V·φ including the branch energy (render coloring)."""
    r_base = effective_ref_inv(obj.ref_inv, state.plastic_inv)
    f_e = deformation_gradients(pos, obj.element_indices, r_base)
    phi = energy_density(f_e, obj.mu, obj.s_lambda, obj.material)
    if state.viscous_inv is not None:
        r_branch = effective_ref_inv(obj.ref_inv, state.viscous_inv)
        fbe = deformation_gradients(pos, obj.element_indices, r_branch)
        phi = phi + energy_density(fbe, obj.viscous_mu, 0.0, _BRANCH_MATERIAL)
    return obj.volume * phi


