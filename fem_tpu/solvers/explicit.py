# coding=utf-8
"""Explicit integration: analytic Piola forces or jax.grad of the energy.

Reference:
  * analytic path:  solver/explicit.py:8-49 (one Taichi GPU kernel with atomic
    scatter) — here a batched element kernel + segment-sum assembly;
  * autodiff path:  solver/explicit_auto_diff.py + ``ti.ad.Tape`` at
    main.py:107 — here literally ``jax.grad`` of the total energy, which is
    the JAX replacement for the Taichi tape.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from fem_tpu.models.state import FemObject, SimState
from fem_tpu.ops.assembly import assemble_for, element_contrib_full
from fem_tpu.ops.element import explicit_grad_columns, total_energy


def analytic_energy_gradient(
    obj: FemObject,
    pos: jnp.ndarray,
    axis_name: str | None = None,
    layers=None,
) -> jnp.ndarray:
    """Assembled ∂U/∂x via the reference's analytic per-element formula
    (solver/explicit.py:23-49).  With ``axis_name``, element arrays are local
    shards and the assembly is psum-reduced.

    ``layers`` (ops/inelastic.material_layers) sums the gradient over
    material layers with dynamic effective rest-edge inverses — the
    inelastic extension on the same path (None = the single elastic layer,
    the historical code path)."""
    from fem_tpu.ops.inelastic import layer_ref_inv_local
    from fem_tpu.solvers.implicit import _normalize_layers

    cols = None
    for fi_inv, mu, lam, material in _normalize_layers(obj, layers):
        r_eff = layer_ref_inv_local(obj.ref_inv, fi_inv, axis_name)
        c_l = explicit_grad_columns(
            pos, obj.element_indices, r_eff, obj.volume, mu, lam, material,
        )
        cols = c_l if cols is None else cols + c_l
    return assemble_for(obj, element_contrib_full(cols), axis_name)


def autodiff_energy_gradient(
    obj: FemObject, pos: jnp.ndarray, axis_name: str | None = None
) -> jnp.ndarray:
    """∂U/∂x via reverse-mode AD — the exact contract of the reference's
    ``particles.pos.grad`` after the Taichi tape exits (main.py:107-110,
    consumed at solver/kinematic.py:16)."""
    def energy(p):
        u = total_energy(
            p, obj.element_indices, obj.ref_inv, obj.volume, obj.mu,
            obj.s_lambda, obj.material,
        )
        if axis_name is not None:
            u = jax.lax.psum(u, axis_name)
        return u

    return jax.grad(energy)(pos)


def energy_gradient(
    obj: FemObject, state: SimState, auto_diff: bool,
    axis_name: str | None = None,
) -> jnp.ndarray:
    if auto_diff:
        return autodiff_energy_gradient(obj, state.pos, axis_name)
    return analytic_energy_gradient(obj, state.pos, axis_name)
