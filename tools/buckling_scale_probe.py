# coding=utf-8
"""Buckling analysis at scale on the live backend.

Builds a 3D tet column (Kuhn grid stretched 3:1), solves the unit-load
static equilibrium (host-chunked, two-level-Chebyshev preconditioned —
the measured 3D statics winner), then runs the linearized
buckling pencil solve and reports the critical factor, mode character,
residuals, and wall times.  Euler reference for the continuum column
P_cr = pi^2 E I / (4 L^2) printed alongside (CST tets are stiff in
bending; expect the same converge-from-above behavior the 2D tests pin).

Usage: python tools/buckling_scale_probe.py [--sub 12] [--k 3]
       [--rounds 10] [--inner 800] [--cpu]
"""

import argparse
import sys
import time

sys.path.insert(0, __import__("os").path.dirname(
    __import__("os").path.dirname(__import__("os").path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sub", type=int, default=12)
    ap.add_argument("--k", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--inner", type=int, default=800)
    ap.add_argument("--stretch", type=float, default=3.0)
    ap.add_argument("--side", type=float, default=0.2)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from fem_tpu.models.mesh import construct_3d_grid_mesh
    from fem_tpu.models.state import build_object
    from fem_tpu.solvers.buckling import linear_buckling
    from fem_tpu.solvers.static import solve_static_chunked
    from fem_tpu.utils.config import ObjectConfig

    cfg = ObjectConfig(
        center=(0.0, 0.0, 0.0),
        side_length=args.side,
        subdivisions=args.sub,
        pin_boxes=(((-1.0, -1e-7, -1.0), (1.0, 1e-7, 1.0)),),
    )
    v, f, e = construct_3d_grid_mesh(cfg)
    v = np.asarray(v, np.float32)
    v[:, 1] *= args.stretch
    obj, state = build_object(cfg, v, f, e)
    pos = np.asarray(state.pos)
    height = float(pos[:, 1].max())
    top = np.where(pos[:, 1] > height - 1e-6)[0]
    print(
        f"column: {obj.element_cnt} tets / {obj.particle_cnt} particles, "
        f"{args.side:.2f} x {height:.2f}, pinned base, "
        f"{len(top)} loaded top vertices | backend={jax.devices()[0].platform}",
        file=sys.stderr, flush=True,
    )

    # Load sized well below the Euler estimate so the preload is linear.
    mu_l, lam_l = cfg.mu, cfg.s_lambda
    e_mod = mu_l * (3 * lam_l + 2 * mu_l) / (lam_l + mu_l)
    i_sec = args.side**4 / 12.0
    p_euler = np.pi**2 * e_mod * i_sec / (4.0 * height**2)
    p_apply = 0.02 * p_euler
    fext = np.zeros_like(pos)
    fext[top, 1] = -p_apply / len(top)

    t0 = time.time()
    base = solve_static_chunked(
        obj, state.pos, f_ext=jnp.asarray(fext), chunk_newton=2,
        max_newton=30, cg_iters=1200, cg_precond="two_level_cheb3",
    )
    g = float(base.grad_norm)
    t_static = time.time() - t0
    print(
        f"static: {int(base.iterations)} newton / {int(base.cg_iterations)} "
        f"inner, grad={g:.3e}, converged={bool(base.converged)} "
        f"stalled={bool(base.stalled)}, {t_static:.1f}s",
        file=sys.stderr, flush=True,
    )

    t0 = time.time()
    res = linear_buckling(
        obj, state.pos, f_ext=jnp.asarray(fext), k=args.k,
        rounds=args.rounds, inner_iters=args.inner, base=base,
    )
    factors = np.asarray(res.load_factors)  # forces completion
    t_buck = time.time() - t0
    mode = np.asarray(res.modes[0])
    lateral = float(np.linalg.norm(mode[:, [0, 2]]))
    axial = float(np.linalg.norm(mode[:, 1]))
    p_cr = factors[0] * p_apply
    print(
        f"buckling: factors={np.array2string(factors, precision=3)} "
        f"mu={np.array2string(np.asarray(res.mu), precision=3)} "
        f"res={np.array2string(np.asarray(res.residuals), precision=2)} "
        f"{t_buck:.1f}s",
        file=sys.stderr, flush=True,
    )
    print(
        f"P_cr = {p_cr:.4f} vs Euler fixed-free {p_euler:.4f} "
        f"(ratio {p_cr / p_euler:.3f}); mode-1 lateral/axial = "
        f"{lateral / max(axial, 1e-30):.1f}",
        file=sys.stderr, flush=True,
    )
    print(
        {
            "tets": int(obj.element_cnt),
            "particles": int(obj.particle_cnt),
            "p_cr_over_euler": round(float(p_cr / p_euler), 4),
            "factor": round(float(factors[0]), 4),
            "max_residual": round(float(np.asarray(res.residuals).max()), 6),
            "t_static_s": round(t_static, 1),
            "t_buckling_s": round(t_buck, 1),
        }
    )


if __name__ == "__main__":
    main()
