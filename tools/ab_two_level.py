# coding=utf-8
"""A/B the two-level preconditioner on a controlled large-dt scenario.

A 3D grid slab (construct_3d_grid_mesh) hangs from its pinned top face
under gravity and is integrated with the Newton (true backward Euler)
integrator at a ladder of dt multiples of the reference default — the
regime the coarse-space preconditioner exists for (inner-CG conditioning
grows as dt²).  Prints per-(dt, cg_precond) rows: inner iters/substep and
sustained steps/s.

Usage: python tools/ab_two_level.py [--subdivisions 14] [--seconds 0.4]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--subdivisions", type=int, default=14)
    p.add_argument("--seconds", type=float, default=0.4)
    p.add_argument("--dts", default="5e-4,2e-3,8e-3")
    p.add_argument("--preconds", default="none,two_level")
    p.add_argument("--cg-cap", type=int, default=600)
    p.add_argument("--static", action="store_true",
                   help="A/B solve_static (gravity sag of the pinned slab) "
                        "instead of the Newton dynamics ladder")
    args = p.parse_args()

    import numpy as np

    from fem_tpu.models.mesh import construct_3d_grid_mesh
    from fem_tpu.models.state import Obstacles, build_object
    from fem_tpu.sim import make_frame_fn
    from fem_tpu.utils.config import ObjectConfig, SimConfig

    side = 0.5
    ocfg = ObjectConfig(
        center=(0.25, 0.45, 0.25), side_length=side,
        subdivisions=args.subdivisions, E=4e4, nu=0.3, damping=5.0,
        rho=1000.0,
        pin_boxes=(((-10.0, 0.449 + side, -10.0), (10.0, 10.0, 10.0)),),
    )
    vertices, faces, elements = construct_3d_grid_mesh(ocfg)
    obj, state0 = build_object(ocfg, vertices, faces, elements)
    n_pin = int((1.0 - np.asarray(obj.free_mask)[:, 0]).sum())
    print(
        f"slab: {obj.element_cnt} tets / {obj.particle_cnt} particles, "
        f"{n_pin} pinned (top face)", file=sys.stderr,
    )
    obstacles = Obstacles.from_configs((), 3)

    if args.static:
        from fem_tpu.solvers.static import make_static_solve_fn

        for precond in args.preconds.split(","):
            solve = make_static_solve_fn(
                obj, g_dir=(0.0, -1.0, 0.0), cg_iters=args.cg_cap,
                cg_precond=precond,
            )
            res = solve(state0.pos)  # compile + run
            np.asarray(res.pos)
            t0 = time.perf_counter()
            res = solve(state0.pos)
            sag = float(np.asarray(res.pos)[:, 1].min())
            wall = time.perf_counter() - t0
            print(
                f"static precond={precond}: newton {int(res.iterations)}, "
                f"cg {int(res.cg_iterations)}, "
                f"grad_norm {float(res.grad_norm):.3e}, "
                f"converged={bool(res.converged)} "
                f"stalled={bool(res.stalled)}, wall {wall:.2f}s, "
                f"min y {sag:.4f}"
            )
        return

    for dt in [float(x) for x in args.dts.split(",")]:
        for precond in args.preconds.split(","):
            cfg = SimConfig(
                dim=3, delta_time=dt, sim_count=10, auto_diff=False,
                use_explicit_method=False, implicit_method=1,
                preconditioned=0, g_dir=(0.0, -1.0, 0.0),
                objects=(ocfg,), blocks=(),
                integrator="newton", newton_hessian="decoupled",
                newton_cg_iters=args.cg_cap, cg_precond=precond,
            )
            frame = make_frame_fn(obj, cfg)
            state = state0
            # Warm up + compile.
            state, aux = frame(state, obstacles)
            np.asarray(state.pos)
            n_frames = max(2, int(round(args.seconds / (dt * 10))))
            t0 = time.perf_counter()
            iters = 0
            for _ in range(n_frames):
                state, aux = frame(state, obstacles)
                iters += int(np.asarray(aux.solver_iterations).sum())
            pos = np.asarray(state.pos)
            wall = time.perf_counter() - t0
            substeps = n_frames * 10
            ok = bool(np.isfinite(pos).all())
            print(
                f"dt={dt:g} precond={precond}: "
                f"{iters / substeps:.1f} inner iters/substep, "
                f"{substeps / wall:.1f} steps/s "
                f"({substeps * dt:.2f} virtual s, finite={ok})"
            )


if __name__ == "__main__":
    main()
