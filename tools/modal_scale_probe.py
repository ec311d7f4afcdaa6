# coding=utf-8
"""Modal analysis at scale: smallest-k modes of the 68k-tet (or any
--spacing) procedural blob on the device, matrix-free (solvers/modal.py).

The eigensolver never materializes K (dense K at 68k tets / 12,037
particles would be 36,111² f32 = 5.2 GB); every operator application is
the exact material HVP in O(E).  Reports wall time, eigenvalues and
relative residuals — the residual IS the accuracy claim (no oracle exists
at this scale).

The body is pinned along its top slab (``--pin-top`` fraction of the
height) so the lowest modes are physical bending/swing modes rather than
rigid motions — the hanging-part setup of examples/modal_modes.py at scale.

Usage: python tools/modal_scale_probe.py [--spacing 0.04] [--k 6]
       [--m 60] [--inner 300]
"""

import argparse
import os
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--spacing", type=float, default=0.04)
    p.add_argument("--k", type=int, default=6)
    p.add_argument("--m", type=int, default=60)
    p.add_argument("--inner", type=int, default=300)
    p.add_argument("--chunk-m", type=int, default=4,
                   help="LOBPCG steps per device program (warm restarts "
                        "bound each program's length; 0 = single program)")
    p.add_argument("--material", default="neo_hookean")
    p.add_argument("--method", default="chebyshev",
                   choices=["chebyshev", "shift_invert"],
                   help="chebyshev = filtered subspace iteration (scales; "
                        "no inner solves); shift_invert = inner-CG LOBPCG "
                        "(collapses at scale: eps >> lambda_1)")
    p.add_argument("--degree", type=int, default=500,
                   help="Chebyshev filter degree per round (HVPs/round)")
    p.add_argument("--rounds", type=int, default=10)
    p.add_argument("--pin-top", type=float, default=0.1,
                   help="pin vertices in the top FRACTION of the body height"
                        " (0 = free-floating: expect 6 rigid modes at ~0 Hz)")
    p.add_argument("--refine-f64", action="store_true",
                   help="chase the f32 solve with the float64 Chebyshev "
                        "refinement on the host CPU (modal_refine_f64) — "
                        "reports residuals at the TRUE subspace accuracy "
                        "instead of the f32 HVP-noise floor")
    p.add_argument("--refine-rounds", type=int, default=2)
    p.add_argument("--refine-degree", type=int, default=120)
    p.add_argument("--sparse-f64", action="store_true",
                   help="also run the direct f64 sparse shift-invert oracle "
                        "(modal_analysis_sparse_f64: exact f64 element "
                        "Hessians + ARPACK) — machine-precision residuals "
                        "at any conditioning, validates the f32 route "
                        "directly")
    p.add_argument("--resid-f64", action="store_true",
                   help="re-evaluate the f32 modes with the f64-accumulated "
                        "HVP (weights f32, math f64, host CPU) — a DIRECT "
                        "residual measurement of the f32 subspace below the "
                        "f32 HVP noise floor (modal_residuals_f64); does "
                        "not refine the modes")
    args = p.parse_args()

    import jax
    import jax.numpy as jnp

    from fem_tpu.models.mesh import load_object_mesh
    from fem_tpu.models.state import build_object
    from fem_tpu.solvers.modal import modal_analysis
    from fem_tpu.utils.config import ObjectConfig

    here = Path(__file__).resolve().parent.parent
    ocfg = ObjectConfig(
        center=(2.0, 0.7, 2.0), rho=1000.0, E=4e4, nu=0.4,
        obj=str(here / "assets" / "spot.obj"), material=args.material,
    )
    t0 = time.time()
    v, f, e, _ = load_object_mesh(ocfg, interior_spacing=args.spacing)
    obj, state = build_object(ocfg, v, f, e)
    if args.pin_top > 0:
        y = np.asarray(state.pos)[:, 1]
        cut = y.max() - args.pin_top * (y.max() - y.min())
        free = (y < cut).astype(np.float32)[:, None]
        obj = obj.replace(free_mask=jnp.asarray(free))
        print(f"pinned {int((free == 0).sum())} top vertices (y >= "
              f"{cut:.3f})", file=sys.stderr)
    print(
        f"meshed in {time.time() - t0:.1f}s: {state.pos.shape[0]} particles,"
        f" {e.shape[0]} tets (dense K would be "
        f"{(state.pos.size) ** 2 * 4 / 1e9:.1f} GB)",
        file=sys.stderr,
    )
    t0 = time.time()
    if args.method == "chebyshev":
        from fem_tpu.solvers.modal import modal_analysis_chebyshev

        res = modal_analysis_chebyshev(
            obj, state.pos, k=args.k, rounds=args.rounds,
            degree=args.degree,
        )
    else:
        res = modal_analysis(
            obj, state.pos, k=args.k, m=args.m, inner_iters=args.inner,
            chunk_m=args.chunk_m or None,
        )
    omega_sq = np.asarray(res.omega_sq)
    wall = time.time() - t0
    print(f"modal solve ({args.k} modes, m={args.m}, inner={args.inner}): "
          f"{wall:.1f}s on {jax.default_backend()}")
    print("omega_sq:", omega_sq)
    print("frequencies (Hz):", np.asarray(res.frequencies))
    print("relative residuals:", np.asarray(res.residuals))
    if args.resid_f64:
        from fem_tpu.solvers.modal import modal_residuals_f64

        t0 = time.time()
        rr = modal_residuals_f64(obj, state.pos, res)
        print(f"f64-accumulated residuals of the f32 modes "
              f"({time.time() - t0:.1f}s, host CPU, k f64 HVPs):")
        print("  rayleigh omega_sq:", np.asarray(rr.omega_sq))
        print("  direct residuals:", np.asarray(rr.residuals))
        print("  f32-reported residuals (HVP noise floor):",
              np.asarray(res.residuals))
    if args.refine_f64:
        from fem_tpu.solvers.modal import modal_refine_f64

        t0 = time.time()
        r64 = modal_refine_f64(
            obj, state.pos, result=res, k=args.k,
            rounds=args.refine_rounds, degree=args.refine_degree,
        )
        w64 = np.asarray(r64.omega_sq)
        print(f"f64 refine ({args.refine_rounds} rounds x degree "
              f"{args.refine_degree}, host CPU): {time.time() - t0:.1f}s")
        print("f64 omega_sq:", w64)
        print("f64 relative residuals:", np.asarray(r64.residuals))
        print("f32 vs f64 omega_sq rel err:",
              np.abs(omega_sq - w64) / np.abs(w64))
        if args.resid_f64:
            from fem_tpu.solvers.modal import modal_residuals_f64

            rr64 = modal_residuals_f64(obj, state.pos, r64)
            print("direct f64 residuals of the REFINED modes:",
                  np.asarray(rr64.residuals))
    if args.sparse_f64:
        from fem_tpu.solvers.modal import modal_analysis_sparse_f64

        t0 = time.time()
        rs = modal_analysis_sparse_f64(obj, state.pos, k=args.k)
        ws = np.asarray(rs.omega_sq)
        print(f"sparse f64 shift-invert oracle: {time.time() - t0:.1f}s "
              f"(host; exact f64 element Hessians + ARPACK)")
        print("  omega_sq:", ws)
        print("  direct residuals:", np.asarray(rs.residuals))
        print("  f32-route omega_sq rel err vs oracle:",
              np.abs(omega_sq - ws) / np.abs(ws))


if __name__ == "__main__":
    main()
