# coding=utf-8
"""Scale showcase: a ~100k-tet soft body on one device.

At this size the reference's dense implicit matrix would need
(N·d)² · 4 bytes ≈ hundreds of GB–TB; the matrix-free design runs it in MHB
of state.  Usage:

    python tools/scale_demo.py [--spacing 0.035] [--seconds 0.5] [--render]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--spacing", type=float, default=0.035)
    p.add_argument("--dt", type=float, default=2.5e-4,
                   help="substep dt.  The config default 5e-4 is MARGINALLY "
                        "unstable at ~68k tets under pure reference "
                        "semantics (kappa = dt^2*||K||/m approaches 1 for "
                        "the decoupled-Hessian implicit integrator as "
                        "element size shrinks; the sim NaNs ~0.2s after "
                        "impact, robust_inversion does not help).  2.5e-4 "
                        "is stable through t>=1.2s at spacing 0.04.")
    p.add_argument("--seconds", type=float, default=0.5)
    p.add_argument("--warm-seconds", type=float, default=0.6,
                   help="simulate through the floor impact first so the "
                        "measured window has real deformation + CG work")
    p.add_argument("--render", action="store_true")
    p.add_argument("--gif-frames", type=int, default=0,
                   help="after the measured window, render this many frames "
                        "into --gif (demo artifact; 0 = off)")
    p.add_argument("--gif", default="demo/3d_scale_68k/video.gif")
    p.add_argument("--method", default="implicit_cg",
                   choices=["implicit_cg", "explicit"])
    p.add_argument("--robust-inversion", action="store_true",
                   help="enable the robust clamp extension (default: pure "
                        "reference semantics — stable on conforming meshes)")
    p.add_argument("--cg-precond", default="reference",
                   choices=["reference", "none", "block_jacobi"],
                   help="CG preconditioning strategy (SimConfig.cg_precond)")
    p.add_argument("--material", default="neo_hookean",
                   choices=["neo_hookean", "stvk", "linear", "corotated",
                            "stable_neo_hookean"])
    p.add_argument("--adaptive-dt", action="store_true",
                   help="enable the kappa-guard substep splitter")
    p.add_argument("--integrator", default="semi_implicit",
                   choices=["semi_implicit", "newton"],
                   help="implicit time integration: the reference's single "
                        "linearized solve, or fully implicit backward Euler "
                        "(solvers/newton.py — removes the dt~h cap)")
    p.add_argument("--newton-hessian", default="exact",
                   choices=["exact", "decoupled"],
                   help="Newton Jacobian: exact HVP or the decoupled "
                        "one-block-per-element operator")
    p.add_argument("--plastic-yield", type=float, default=0.0,
                   help="von-Mises yield strain (inelastic extension, "
                        "ops/inelastic.py)")
    p.add_argument("--viscous-mu", type=float, default=0.0,
                   help="Maxwell-branch shear modulus (viscoelasticity)")
    p.add_argument("--viscous-tau", type=float, default=0.05,
                   help="Maxwell-branch relaxation time constant")
    args = p.parse_args()

    from fem_tpu.models.mesh import load_object_mesh
    from fem_tpu.models.state import Obstacles, build_object
    from fem_tpu.sim import make_frame_fn
    from fem_tpu.utils.config import ObjectConfig, SimConfig
    from fem_tpu.utils.profiling import frame_metrics

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ocfg = ObjectConfig(
        center=(2.0, 0.7, 2.0), rho=1000.0, E=4e4, nu=0.4, damping=10.0,
        obj=os.path.join(here, "assets", "spot.obj"),
        material=args.material,
        plastic_yield=args.plastic_yield,
        viscous_mu=args.viscous_mu,
        viscous_tau=args.viscous_tau,
    )
    t0 = time.perf_counter()
    v, f, e, _aux = load_object_mesh(ocfg, args.spacing)
    obj, state = build_object(ocfg, v, f, e)
    print(
        f"meshed in {time.perf_counter() - t0:.1f}s: "
        f"{obj.particle_cnt} particles, {obj.element_cnt} tets "
        f"(dense A would be "
        f"{(obj.particle_cnt * 3) ** 2 * 4 / 1e9:.1f} GB)",
        flush=True,
    )

    implicit = args.method == "implicit_cg"
    cfg = SimConfig(
        dim=3, sim_count=10, auto_diff=False, delta_time=args.dt,
        use_explicit_method=not implicit,
        implicit_method=1, preconditioned=1,
        g_dir=(0.0, -1.0, 0.0), robust_inversion=args.robust_inversion,
        cg_precond=args.cg_precond, adaptive_dt=args.adaptive_dt,
        integrator=args.integrator,
        newton_hessian=args.newton_hessian,
        objects=(ocfg,), blocks=(),
    )
    obstacles = Obstacles.from_configs((), 3)
    frame = make_frame_fn(obj, cfg)

    t0 = time.perf_counter()
    s, aux = frame(state, obstacles)
    _ = np.asarray(s.pos)
    print(f"compile+first frame: {time.perf_counter() - t0:.1f}s", flush=True)

    warm_frames = int(args.warm_seconds / (cfg.sim_count * cfg.delta_time))
    for _ in range(warm_frames):
        s, aux = frame(s, obstacles)
    _ = np.asarray(s.pos)  # hard sync before starting the clock
    m = frame_metrics(obj, s)
    iters = float(np.asarray(aux.solver_iterations).mean())
    print(
        f"warmed through impact: min det F={m.min_det_f:.3f} "
        f"CG iters/substep={iters:.1f}",
        flush=True,
    )

    n_frames = int(args.seconds / (cfg.sim_count * cfg.delta_time))
    t0 = time.perf_counter()
    for _ in range(n_frames):
        s, aux = frame(s, obstacles)
    _ = np.asarray(s.pos)  # hard sync ends the timed region
    wall = time.perf_counter() - t0
    steps = n_frames * cfg.sim_count
    m = frame_metrics(obj, s)
    iters = float(np.asarray(aux.solver_iterations).mean())
    cg_iters_per_s = iters * steps / wall
    print(
        f"{steps} substeps in {wall:.2f}s = {steps / wall:.0f} steps/s "
        f"({obj.element_cnt * steps / wall:.2e} element-steps/s, "
        f"{cg_iters_per_s:.0f} CG iters/s)  "
        f"CG iters/substep={iters:.1f}  "
        f"min det F={m.min_det_f:.3f}  finite={not m.any_nan}",
        flush=True,
    )

    if args.render:
        from PIL import Image

        from fem_tpu.render.raster import render_frame_3d

        img = render_frame_3d(
            np.asarray(s.pos), np.asarray(obj.faces), elev=20, azim=-70
        )
        out = "/tmp/scale_demo.png"
        Image.fromarray(img).save(out)
        print(f"wrote {out}")

    if args.gif_frames:
        # Demo artifact: continue the sim past the measured window and
        # render every frame (device->host fetch per frame is fine here —
        # nothing is being timed).
        from PIL import Image

        from fem_tpu.render.raster import render_frame_3d

        frames = []
        for i in range(args.gif_frames):
            s, aux = frame(s, obstacles)
            frames.append(
                Image.fromarray(
                    render_frame_3d(
                        np.asarray(s.pos), np.asarray(obj.faces),
                        elev=20, azim=-70,
                    )
                )
            )
        os.makedirs(os.path.dirname(args.gif) or ".", exist_ok=True)
        frames[0].save(
            args.gif, save_all=True, append_images=frames[1:],
            duration=int(1000 * cfg.sim_count * cfg.delta_time * 8),
            loop=0,
        )
        print(f"wrote {args.gif} ({len(frames)} frames)")


if __name__ == "__main__":
    main()
