# coding=utf-8
"""Batched simulation: many independent simulations per device dispatch.

New capability with no reference counterpart: `vmap` the substep
over a leading batch axis of states — ensembles of initial conditions,
parameter sweeps over obstacle layouts, or Monte-Carlo perturbations — all
sharing one mesh, compiled once, filling the device that a single small mesh
leaves idle.  This is how a 642-particle body becomes a large workload on
hardware built for batch parallelism.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from fem_tpu.models.state import FemObject, Obstacles, SimState
from fem_tpu.sim import _cfg_kwargs, substep
from fem_tpu.utils.config import SimConfig


def broadcast_state(state: SimState, batch: int) -> SimState:
    """Tile a single state into a (B, ...) batched state."""
    return jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x[None], (batch,) + x.shape), state
    )


def perturb_states(
    state: SimState, batch: int, scale: float, seed: int = 0
) -> SimState:
    """Batched state with per-sample position noise (ensemble runs)."""
    base = broadcast_state(state, batch)
    rng = np.random.default_rng(seed)
    noise = rng.normal(scale=scale, size=base.pos.shape).astype(np.float32)
    return base.replace(pos=base.pos + jnp.asarray(noise))


def make_sharded_batched_frame_fn(obj: FemObject, cfg: SimConfig, mesh):
    """Data-parallel ensembles: the batch axis sharded over a device mesh.

    The complementary axis to element sharding (fem_tpu/parallel): ensemble
    members are independent, so the batch dimension shards with *zero*
    collectives — pure pjit-style auto-partitioning.  Pass a 1-D
    ``jax.sharding.Mesh``; states come back sharded the same way.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    axis = mesh.axis_names[0]
    frame = make_batched_frame_fn(obj, cfg)
    batch_sharding = NamedSharding(mesh, P(axis))

    def sharded_frame(states: SimState, obstacles: Obstacles):
        states = jax.tree_util.tree_map(
            lambda x: jax.device_put(x, batch_sharding), states
        )
        return frame(states, obstacles)

    return sharded_frame


def make_batched_frame_fn(obj: FemObject, cfg: SimConfig):
    """Compiled frame function over a batch of states: one mesh, B
    simulations, `sim_count` substeps, a single device dispatch.

    Obstacles may be unbatched (shared) or batched over the leading axis
    (per-sample layouts) — pass ``batched_obstacles=True`` at call time is
    not needed; both shapes are accepted by tracing.
    """
    kwargs = _cfg_kwargs(cfg)

    def one(o: FemObject, state: SimState, obstacles: Obstacles):
        def body(s, _):
            return substep(o, s, obstacles, **kwargs)

        return jax.lax.scan(body, state, None, length=cfg.sim_count)

    @jax.jit
    def batched_shared(o: FemObject, states: SimState, obstacles: Obstacles):
        return jax.vmap(one, in_axes=(None, 0, None))(o, states, obstacles)

    @jax.jit
    def batched_per_sample(
        o: FemObject, states: SimState, obstacles: Obstacles
    ):
        return jax.vmap(one, in_axes=(None, 0, 0))(o, states, obstacles)

    def frame(states: SimState, obstacles: Obstacles):
        if obstacles.centers.ndim == 3:  # (B, nblocks, d)
            return batched_per_sample(obj, states, obstacles)
        return batched_shared(obj, states, obstacles)

    return frame
