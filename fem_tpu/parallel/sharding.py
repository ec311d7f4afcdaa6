# coding=utf-8
"""Multi-device scaling: element-sharded simulation over a device mesh.

The reference is a single-process single-GPU program whose only parallelism is
Taichi's auto-parallelized outer kernel loop with atomic adds (SURVEY §2).
The multi-device analogue is *data parallelism over elements*: element arrays
(indices, ref_inv, volume) are sharded along a 1-D ``jax.sharding.Mesh`` axis,
each shard computes its local per-element math and local segment-sum, and one
``psum`` over the interconnect produces the fully assembled per-particle
quantities, replicated on every shard.  Particle-space solver iterations (CG/Jacobi) then
run replicated — identical arithmetic on every device — so only one small (N·d)
collective per operator application crosses the interconnect per iteration.

Padding: element counts rarely divide the mesh size, so shards are padded by
*repeating element 0 with volume 0* — a geometrically valid element whose
force, energy, and Hessian contributions are exactly zero (every contribution
is scaled by V), keeping all math finite without masking.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from fem_tpu.models.state import FemObject, Obstacles, SimState
from fem_tpu.sim import StepAux, substep
from fem_tpu.utils.config import SimConfig

AXIS = "elem"


def pad_elements(obj: FemObject, multiple: int) -> FemObject:
    """Pad element arrays so the element count divides ``multiple``; padding
    repeats element 0 with volume 0 (zero contribution, finite math)."""
    e = obj.element_cnt
    target = ((e + multiple - 1) // multiple) * multiple
    pad = target - e
    if pad == 0:
        # The sharded path assembles by segment-sum + psum: the gather
        # plan's row indices are GLOBAL over all elements, so a shard
        # would gather rows it does not hold, and halo particles span
        # shards, so the psum over the (N, d) particle space is needed
        # regardless.  Drop the two-tier plan so every remaining array
        # leaf has a PartitionSpec in the shard_map spec pytrees below.
        return obj.replace(gather_hi=None, gather_out=None)
    idx = jnp.concatenate(
        [obj.element_indices, jnp.tile(obj.element_indices[:1], (pad, 1))]
    )
    ref_inv = jnp.concatenate(
        [obj.ref_inv, jnp.tile(obj.ref_inv[:1], (pad, 1, 1))]
    )
    volume = jnp.concatenate([obj.volume, jnp.zeros((pad,), obj.volume.dtype)])
    from fem_tpu.ops.assembly import build_gather_plan

    # Padded elements scatter into element 0's Jacobi-plan slots with zero
    # coefficients — exact zero contribution regardless of their K blocks.
    jac_slots = jac_coeff = None
    if obj.jacobi_slots is not None:
        jac_slots = jnp.concatenate(
            [obj.jacobi_slots, jnp.tile(obj.jacobi_slots[:1], (pad, 1))]
        )
        jac_coeff = jnp.concatenate(
            [
                obj.jacobi_coeff,
                jnp.zeros((pad,) + obj.jacobi_coeff.shape[1:],
                          obj.jacobi_coeff.dtype),
            ]
        )
    return obj.replace(
        element_indices=idx, ref_inv=ref_inv, volume=volume,
        element_cnt=target,
        gather_idx=jnp.asarray(
            build_gather_plan(np.asarray(idx), obj.particle_cnt)
        ),
        gather_hi=None,
        gather_out=None,
        jacobi_slots=jac_slots,
        jacobi_coeff=jac_coeff,
        edge_matrix=None,  # the "mxu" operator mode is single-device only
    )


def make_element_mesh(
    n_devices: Optional[int] = None, devices: Optional[Sequence] = None
) -> Mesh:
    """1-D device mesh over the ``elem`` axis."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[: n_devices]
    return Mesh(np.array(devices), (AXIS,))


def _pad_internal(state: SimState, target_e: int) -> SimState:
    """Pad the per-element internal-variable inverses (inelastic extension)
    to the padded element count with identity rows — padded elements carry
    volume 0, so their internal state is inert (advance_internal writes
    finite values there; nothing reads them with nonzero weight)."""
    def pad(x):
        if x is None or x.shape[-3] == target_e:
            return x
        eye = jnp.broadcast_to(
            jnp.eye(x.shape[-1], dtype=x.dtype),
            x.shape[:-3] + (target_e - x.shape[-3],) + x.shape[-2:],
        )
        return jnp.concatenate([x, eye], axis=-3)

    return state.replace(
        plastic_inv=pad(state.plastic_inv), viscous_inv=pad(state.viscous_inv)
    )


def _slice_internal(state: SimState, orig_e: int) -> SimState:
    """Inverse of :func:`_pad_internal` on the returned state."""
    def cut(x):
        if x is None or x.shape[-3] == orig_e:
            return x
        return x[..., :orig_e, :, :]

    return state.replace(
        plastic_inv=cut(state.plastic_inv), viscous_inv=cut(state.viscous_inv)
    )


def _sharded_kwargs(cfg: SimConfig) -> dict:
    """The substep kwargs shared by every sharded builder."""
    return dict(
        dt=cfg.delta_time,
        g_dir=cfg.g_dir,
        use_explicit_method=cfg.use_explicit_method,
        auto_diff=cfg.auto_diff,
        implicit_method=cfg.implicit_method,
        preconditioned=cfg.preconditioned,
        jacobi_sweep=cfg.jacobi_sweep,
        cg_precond=cfg.cg_precond,
        robust_inversion=cfg.robust_inversion,
        hessian=cfg.hessian,
        integrator=cfg.integrator,
        newton_iters=cfg.newton_iters,
        newton_cg_iters=cfg.newton_cg_iters,
        newton_tol=cfg.newton_tol,
        newton_hessian=cfg.newton_hessian,
        newton_theta=cfg.newton_theta,
        wall_friction=cfg.wall_friction,
        axis_name=AXIS,
        solver_backend="matrix_free",  # dense backend is single-device only
        operator_mode=cfg.operator_mode,
    )


def _prep_body(obj: FemObject, cfg: SimConfig, n_shards: int):
    """(padded object, its PartitionSpec pytree, local element count) for
    one body: element arrays shard over the mesh axis, particle arrays
    replicate."""
    padded = pad_elements(obj, n_shards)
    if padded.element_cnt == obj.element_cnt:
        # pad_elements may have returned the object unchanged; the sharded
        # path never uses the dense edge matrix, so drop it (it would need a
        # PartitionSpec otherwise).
        padded = padded.replace(edge_matrix=None)
    local_cnt = padded.element_cnt // n_shards
    # Built with .replace so the spec pytree's static fields match `padded`'s.
    obj_spec = padded.replace(
        element_indices=P(AXIS), ref_inv=P(AXIS), volume=P(AXIS),
        mass=P(), rest_pos=P(), faces=P(), gather_idx=P(),
        jacobi_nb=P(), jacobi_slots=P(AXIS), jacobi_coeff=P(AXIS),
    )
    if padded.free_mask is not None:
        obj_spec = obj_spec.replace(free_mask=P())  # particle-space: replicate
    if padded.static_load is not None:
        obj_spec = obj_spec.replace(static_load=P())  # particle-space: replicate
    if padded.pin_vel is not None:
        obj_spec = obj_spec.replace(pin_vel=P())  # particle-space: replicate
    if padded.agg_ids is not None:  # coarse space: replicate
        obj_spec = obj_spec.replace(agg_ids=P(), agg_basis=P())
    return padded, obj_spec, local_cnt


def _localize(obj_shard: FemObject, local_cnt: int):
    """Rewrite a shard's static counts (shard_map slices only the arrays)."""
    return obj_shard.replace(element_cnt=local_cnt, assembly_mode="segment")


def _state_spec_for(obj: FemObject, batch: str | None = None) -> SimState:
    ax = P(batch) if batch else P()
    return SimState(
        pos=ax, vel=ax, vel_g=ax, force=ax, jacobi_past_x=ax,
        plastic_inv=ax if obj.plastic_yield > 0.0 else None,
        viscous_inv=ax if obj.viscous_mu > 0.0 else None,
    )


def _build(obj: FemObject, cfg: SimConfig, mesh: Mesh, scan_frame: bool):
    """Shared builder for the sharded substep / frame functions.

    Inelastic configs (plastic_yield/viscous_mu): the per-element internal
    variables ride the state pytree REPLICATED over the full padded element
    range — each shard slices its contiguous rows for layer composition
    (ops/inelastic.layer_ref_inv_local) and for the per-substep update,
    which all_gathers back to replicated (advance_internal)."""
    inelastic = obj.plastic_yield > 0.0 or obj.viscous_mu > 0.0
    n_shards = mesh.devices.size
    padded, obj_spec, local_cnt = _prep_body(obj, cfg, n_shards)

    state_spec = _state_spec_for(obj)
    # Pytree-prefix spec: one replicated P() covers every obstacle
    # leaf, including the optional SDF extension fields (which are
    # None under pure reference configs).
    obs_spec = P()
    aux_spec = StepAux(P(), P())
    kwargs = _sharded_kwargs(cfg)

    def local_fn(obj_shard: FemObject, state, obstacles):
        local = _localize(obj_shard, local_cnt)
        if scan_frame:
            def body(s, _):
                return substep(local, s, obstacles, **kwargs)

            return jax.lax.scan(body, state, None, length=cfg.sim_count)
        return substep(local, state, obstacles, **kwargs)

    sharded = jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(obj_spec, state_spec, obs_spec),
        out_specs=(state_spec, aux_spec),
        # Particle-space results are replicated by construction (every
        # shard runs the same arithmetic on psum-reduced inputs);
        # correctness of the psum placement is pinned by the parity tests.
        check_vma=False,
    )

    # `padded` is a jit argument, never a closure constant (see the NOTE in
    # fem_tpu/sim.py — captured mesh arrays compile and run pathologically).
    jit_sharded = jax.jit(sharded)

    orig_e = obj.element_cnt

    def run(state: SimState, obstacles: Obstacles):
        if inelastic:
            state = _pad_internal(state, padded.element_cnt)
        out_state, aux = jit_sharded(padded, state, obstacles)
        if inelastic:
            out_state = _slice_internal(out_state, orig_e)
        return out_state, aux

    return run


def make_2d_mesh(
    batch_size: int, elem_size: int, devices: Optional[Sequence] = None
) -> Mesh:
    """2-D device mesh: ensembles × elements (("batch", "elem") axes)."""
    if devices is None:
        devices = jax.devices()
    devices = np.array(devices[: batch_size * elem_size]).reshape(
        batch_size, elem_size
    )
    return Mesh(devices, ("batch", AXIS))


def make_batched_sharded_frame_fn(obj: FemObject, cfg: SimConfig, mesh: Mesh):
    """Composed parallelism over a 2-D ``("batch", "elem")`` device mesh:
    ensemble members shard over ``batch`` (independent — zero collectives)
    while each member's elements shard over ``elem`` (one ``psum`` per
    assembly).  B·S devices simulate B·S-times the work of one device with
    only the small per-iteration particle-space reduction.

    Call with a batched :class:`SimState` (leading axis divisible by the
    batch-mesh size) and unbatched obstacles.
    """
    n_elem_shards = mesh.shape[AXIS]
    inelastic = obj.plastic_yield > 0.0 or obj.viscous_mu > 0.0
    padded, obj_spec, local_cnt = _prep_body(obj, cfg, n_elem_shards)

    state_spec = _state_spec_for(obj, batch="batch")
    # Pytree-prefix spec: one replicated P() covers every obstacle
    # leaf, including the optional SDF extension fields (which are
    # None under pure reference configs).
    obs_spec = P()
    aux_spec = StepAux(P("batch"), P("batch"))
    kwargs = _sharded_kwargs(cfg)

    def local_fn(obj_shard: FemObject, states, obstacles):
        local = _localize(obj_shard, local_cnt)

        def one(state):
            def body(s, _):
                return substep(local, s, obstacles, **kwargs)

            return jax.lax.scan(body, state, None, length=cfg.sim_count)

        return jax.vmap(one)(states)

    sharded = jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(obj_spec, state_spec, obs_spec),
        out_specs=(state_spec, aux_spec),
        # Particle-space results are replicated by construction (every
        # shard runs the same arithmetic on psum-reduced inputs);
        # correctness of the psum placement is pinned by the parity tests.
        check_vma=False,
    )
    jit_sharded = jax.jit(sharded)

    orig_e = obj.element_cnt

    def run(states: SimState, obstacles: Obstacles):
        if inelastic:
            states = _pad_internal(states, padded.element_cnt)
        out_states, aux = jit_sharded(padded, states, obstacles)
        if inelastic:
            out_states = _slice_internal(out_states, orig_e)
        return out_states, aux

    return run


def make_sharded_frame_fn(obj: FemObject, cfg: SimConfig, mesh: Mesh):
    """Compiled frame function (``sim_count`` substeps) with elements sharded
    over ``mesh``; drop-in replacement for :func:`fem_tpu.sim.make_frame_fn`."""
    return _build(obj, cfg, mesh, scan_frame=True)


def make_sharded_contact_frame_fn(
    objs: Sequence[FemObject], cfg: SimConfig, mesh: Mesh
):
    """Multi-body penalty-contact frame under ``shard_map`` (round 5,
    VERDICT r4 #2a) — drop-in for :func:`fem_tpu.contact.make_contact_frame_fn`.

    Sharding story: the contact pair forces are PARTICLE-space math on the
    (replicated) positions — every shard computes them identically with zero
    collectives, exactly like the replicated CG iterations — while each
    body's element work (force assembly, operator applies) shards over the
    mesh axis with one psum per assembly.  The pair force enters each body's
    substep through the same ``external_force`` rhs fold as single-chip, so
    results match the single-device contact frame to float reassociation
    (tests/test_sharding.py)."""
    from fem_tpu.contact import (
        auto_contact_radius,
        auto_contact_stiffness,
        build_contact_plan,
        contact_forces_all,
    )

    objs = tuple(objs)
    n_shards = mesh.devices.size
    kwargs = _sharded_kwargs(cfg)
    radius = (
        cfg.contact_radius
        if cfg.contact_radius > 0.0
        else auto_contact_radius(objs)
    )
    stiffness = (
        cfg.contact_stiffness
        if cfg.contact_stiffness > 0.0
        else auto_contact_stiffness(objs, cfg.delta_time)
    )
    m_min = min(float(np.asarray(o.mass).min()) for o in objs)
    friction_c = cfg.contact_friction * float(np.sqrt(stiffness * m_min))
    mu = cfg.contact_mu
    mu_slope = float(np.sqrt(stiffness * m_min))
    plan = build_contact_plan(objs, cfg, radius)

    prepped = [_prep_body(o, cfg, n_shards) for o in objs]
    padded_objs = tuple(p[0] for p in prepped)
    obj_specs = tuple(p[1] for p in prepped)
    local_cnts = tuple(p[2] for p in prepped)
    inelastic = any(
        o.plastic_yield > 0.0 or o.viscous_mu > 0.0 for o in objs
    )

    states_spec = tuple(_state_spec_for(o) for o in objs)
    obs_spec = P()
    aux_spec = tuple(StepAux(P(), P()) for _ in objs)

    def local_fn(objs_shard, plan_, states, obstacles):
        locals_ = [_localize(o, c) for o, c in zip(objs_shard, local_cnts)]

        def body(ss, _):
            forces = contact_forces_all(
                [s.pos for s in ss], radius, stiffness,
                velocities=[s.vel for s in ss], plan=plan_,
                friction_c=friction_c, mu=mu, mu_slope=mu_slope,
            )
            out, auxes = [], []
            for o, s, f in zip(locals_, ss, forces):
                s2, aux = substep(o, s, obstacles, external_force=f, **kwargs)
                out.append(s2)
                auxes.append(aux)
            return tuple(out), tuple(auxes)

        return jax.lax.scan(body, tuple(states), None, length=cfg.sim_count)

    sharded = jax.shard_map(
        local_fn,
        mesh=mesh,
        # The ContactPlan is particle-space static data — replicated
        # (pytree-prefix P(), same convention as the obstacles).
        in_specs=(obj_specs, P(), states_spec, obs_spec),
        out_specs=(states_spec, aux_spec),
        check_vma=False,
    )
    jit_sharded = jax.jit(sharded)
    orig_es = tuple(o.element_cnt for o in objs)

    def frame(states, obstacles: Obstacles):
        if inelastic:
            states = tuple(
                _pad_internal(s, p.element_cnt)
                for s, p in zip(states, padded_objs)
            )
        out_states, auxes = jit_sharded(
            padded_objs, plan, tuple(states), obstacles
        )
        if inelastic:
            out_states = tuple(
                _slice_internal(s, e) for s, e in zip(out_states, orig_es)
            )
        return out_states, auxes

    return frame


def make_sharded_substep_fn(obj: FemObject, cfg: SimConfig, mesh: Mesh):
    """Single sharded substep (tests / multichip dry run)."""
    return _build(obj, cfg, mesh, scan_frame=False)
