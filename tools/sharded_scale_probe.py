# coding=utf-8
"""Sharded execution of the LARGE (68k-tet) mesh on a virtual device mesh.

tests/test_sharding.py pins sharded-vs-single-device parity on small 2D/3D
meshes; this probe runs the compute-bound 68k-tet body through the
element-sharded path on an 8-virtual-device CPU mesh and checks parity —
evidence that the multi-device story holds at the mesh scale it exists for
(SURVEY §5 "meshes that exceed one chip"), not just on toy meshes.  It
validates semantics + compiled collectives, not cross-device throughput
(``chip_smoke.py --four`` runs the sharded path on four GPUs).

Usage:  python tools/sharded_scale_probe.py [--spacing 0.04] [--devices 8]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--spacing", type=float, default=0.04)
    p.add_argument("--devices", type=int, default=8)
    args = p.parse_args()

    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={args.devices}"
    )
    import jax

    # Must precede the first backend touch.
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from fem_tpu.models.mesh import load_object_mesh
    from fem_tpu.models.state import Obstacles, build_object
    from fem_tpu.parallel.sharding import (
        make_element_mesh,
        make_sharded_substep_fn,
    )
    from fem_tpu.sim import make_substep_fn
    from fem_tpu.utils.config import ObjectConfig, SimConfig

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ocfg = ObjectConfig(
        center=(2.0, 0.7, 2.0), rho=1000.0, E=4e4, nu=0.4, damping=10.0,
        obj=os.path.join(here, "assets", "spot.obj"),
    )
    t0 = time.perf_counter()
    v, f, e, _aux = load_object_mesh(ocfg, args.spacing)
    obj, state = build_object(ocfg, v, f, e)
    print(
        f"meshed in {time.perf_counter() - t0:.1f}s: {obj.particle_cnt} "
        f"particles, {obj.element_cnt} tets", flush=True,
    )

    # Squash the body 20% so the implicit solve does real work (free fall at
    # rest pose converges in 0 CG iterations and would test nothing).
    c = state.pos.mean(axis=0, keepdims=True)
    state = state.replace(
        pos=c + (state.pos - c) * jnp.asarray([[1.2, 0.85, 1.1]])
    )

    cfg = SimConfig(
        dim=3, sim_count=10, auto_diff=False, delta_time=2.5e-4,
        use_explicit_method=False, implicit_method=1, preconditioned=1,
        g_dir=(0.0, -1.0, 0.0), objects=(ocfg,), blocks=(),
    )
    obstacles = Obstacles.from_configs((), 3)

    t0 = time.perf_counter()
    single = make_substep_fn(obj, cfg)
    s1, aux1 = single(state, obstacles)
    p1 = np.asarray(s1.pos)
    print(
        f"single-device substep: {time.perf_counter() - t0:.1f}s "
        f"(incl. compile), {int(np.asarray(aux1.solver_iterations))} CG iters",
        flush=True,
    )

    mesh = make_element_mesh(args.devices)
    t0 = time.perf_counter()
    sharded = make_sharded_substep_fn(obj, cfg, mesh)
    s8, aux8 = sharded(state, obstacles)
    p8 = np.asarray(s8.pos)
    print(
        f"sharded substep ({args.devices} devices, elements sharded): "
        f"{time.perf_counter() - t0:.1f}s (incl. compile), "
        f"{int(np.asarray(aux8.solver_iterations))} CG iters", flush=True,
    )

    diff = float(np.abs(p8 - p1).max())
    iters_match = int(np.asarray(aux1.solver_iterations)) == int(
        np.asarray(aux8.solver_iterations)
    )
    print(f"max |pos_sharded - pos_single| = {diff:.3e}; "
          f"iteration counts match: {iters_match}")
    assert diff <= 1e-5, "sharded trajectory diverged from single-device"
    print(f"sharded_scale_probe OK: {obj.element_cnt} tets / "
          f"{args.devices} devices")


if __name__ == "__main__":
    main()
