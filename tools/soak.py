# coding=utf-8
"""Long-run stability soak on the flagship config.

Runs the 3D implicit-PCG flagship for tens of virtual seconds (orders of
magnitude past the demo lengths) and checks the invariants that matter for
long-running deployment: every field finite, kinetic energy decaying to the
damped rest state, min det F bounded away from 0 after settling, solver
iterations stable.  Reports a window summary every --window virtual seconds
(each report fetches the state to the host; the frames in between pipeline
freely).

Usage: python tools/soak.py [--seconds 30] [--config configs/demo_spot.json]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--window", type=float, default=2.0)
    p.add_argument("--config", default="configs/demo_spot.json")
    p.add_argument("--spacing", type=float, default=None,
                   help="interior mesher spacing override (scale meshes)")
    p.add_argument("--dt", type=float, default=None,
                   help="substep dt override (scale meshes need 2.5e-4)")
    p.add_argument("--robust", action="store_true",
                   help="enable the robust_inversion extension (rescues "
                        "thin-feature element inversions that NaN the "
                        "reference's unclamped log under deep squash)")
    p.add_argument("--cg-precond", default=None,
                   choices=["reference", "none", "block_jacobi", "two_level"],
                   help="override SimConfig.cg_precond")
    p.add_argument("--adaptive-dt", action="store_true",
                   help="enable the kappa-guard substep splitter")
    p.add_argument("--integrator", default=None,
                   choices=["semi_implicit", "newton"],
                   help="override SimConfig.integrator (newton = fully "
                        "implicit backward Euler, solvers/newton.py)")
    p.add_argument("--newton-cg-iters", type=int, default=None,
                   help="override SimConfig.newton_cg_iters (inner CG cap)")
    p.add_argument("--newton-hessian", default=None,
                   choices=["exact", "decoupled"],
                   help="Newton Jacobian: exact HVP or the decoupled "
                        "one-block-per-element operator")
    args = p.parse_args()

    from fem_tpu.models.mesh import load_object_mesh
    from fem_tpu.models.state import Obstacles, build_object
    from fem_tpu.sim import make_frame_fn
    from fem_tpu.utils.config import read_config
    from fem_tpu.utils.profiling import frame_metrics

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = read_config(os.path.join(here, args.config))
    import dataclasses

    if args.dt is not None:
        cfg = dataclasses.replace(cfg, delta_time=args.dt)
    if args.robust:
        cfg = dataclasses.replace(cfg, robust_inversion=True)
    if args.cg_precond is not None:
        cfg = dataclasses.replace(cfg, cg_precond=args.cg_precond)
    if args.adaptive_dt:
        cfg = dataclasses.replace(cfg, adaptive_dt=True)
    if args.integrator is not None:
        cfg = dataclasses.replace(cfg, integrator=args.integrator)
    if args.newton_hessian is not None:
        cfg = dataclasses.replace(cfg, newton_hessian=args.newton_hessian)
    if args.newton_cg_iters is not None:
        cfg = dataclasses.replace(cfg, newton_cg_iters=args.newton_cg_iters)
    ocfg = cfg.objects[0]
    obj_path = os.path.join(here, ocfg.obj)
    ocfg = type(ocfg)(**{**ocfg.__dict__, "obj": obj_path})
    v, f, e, _ = load_object_mesh(ocfg, args.spacing)
    obj, state = build_object(ocfg, v, f, e)
    obstacles = Obstacles.from_configs(cfg.blocks, cfg.dim)
    frame = make_frame_fn(obj, cfg)

    frame_dt = cfg.sim_count * cfg.delta_time
    frames_per_window = max(1, int(args.window / frame_dt))
    n_windows = max(1, int(args.seconds / (frames_per_window * frame_dt)))

    s, aux = frame(state, obstacles)
    _ = np.asarray(s.pos)  # sync: compile done
    t0 = time.perf_counter()
    total_frames = 1
    ok = True
    for w in range(n_windows):
        for _ in range(frames_per_window):
            s, aux = frame(s, obstacles)
        total_frames += frames_per_window
        m = frame_metrics(obj, s)  # fetches → hard sync
        iters = float(np.asarray(aux.solver_iterations).mean())
        t_virt = total_frames * frame_dt
        finite = not m.any_nan
        ok = ok and finite
        print(
            f"t={t_virt:6.2f}s  U={m.elastic_energy:9.4f}  "
            f"KE={m.kinetic_energy:9.6f}  min det F={m.min_det_f:.4f}  "
            f"max|v|={m.max_speed:.4f}  iters/substep={iters:.1f}  "
            f"finite={finite}",
            flush=True,
        )
        if not finite:
            break
    wall = time.perf_counter() - t0
    steps = total_frames * cfg.sim_count
    print(
        f"SOAK {'OK' if ok else 'FAILED'}: {steps} substeps "
        f"({steps * cfg.delta_time:.1f} virtual s) in {wall:.1f}s wall "
        f"= {steps / wall:.0f} steps/s sustained",
        flush=True,
    )
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
