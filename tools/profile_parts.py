# coding=utf-8
"""Microbenchmark of the compute-path pieces on the current backend.

All mesh arrays are passed as jit ARGUMENTS (closure-captured arrays become
XLA constants — see the NOTE in fem_tpu/sim.py).

Usage: python tools/profile_parts.py [--mesh spot|gridN] [--iters 200]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def _sync(out):
    jax.block_until_ready(out)


def timeit(fn, *args, iters=200, warmup=3):
    for _ in range(warmup):
        out = fn(*args)
    _sync(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _sync(out)
    return (time.perf_counter() - t0) / iters * 1e6  # us


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--mesh", default="spot")
    p.add_argument("--iters", type=int, default=200)
    p.add_argument("--spacing", type=float, default=None,
                   help="interior Steiner spacing for spot (denser mesh)")
    args = p.parse_args()

    from fem_tpu.models.mesh import construct_2d_mesh, load_object_mesh
    from fem_tpu.models.state import build_object
    from fem_tpu.ops.assembly import (
        element_contrib_full, gather_assemble, segment_assemble,
    )
    from fem_tpu.ops.element import explicit_grad_columns, hessian_blocks
    from fem_tpu.solvers.implicit import implicit_velocity_solve, make_system_apply
    from fem_tpu.utils.config import ObjectConfig, read_config

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if args.mesh == "spot":
        cfg = read_config(os.path.join(here, "configs", "demo_spot.json"))
        ocfg = type(cfg.objects[0])(
            **{**cfg.objects[0].__dict__,
               "obj": os.path.join(here, cfg.objects[0].obj)}
        )
        v, f, e, _ = load_object_mesh(ocfg, args.spacing)
        obj, state = build_object(ocfg, v, f, e)
        dt_s = cfg.delta_time
    else:
        sub = int(args.mesh[4:]) if args.mesh.startswith("grid") else 64
        ocfg = ObjectConfig(subdivisions=sub, side_length=0.5, center=(0.25, 0.4))
        v, f, e = construct_2d_mesh(ocfg)
        obj, state = build_object(ocfg, v, f, e)
        dt_s = 5e-4

    print(f"backend={jax.default_backend()} particles={obj.particle_cnt} "
          f"elements={obj.element_cnt}", flush=True)

    pos = state.pos
    it = args.iters

    cols_fn = jax.jit(explicit_grad_columns, static_argnums=(4, 5))
    cargs = (obj.element_indices, obj.ref_inv, obj.volume, obj.mu, obj.s_lambda)
    t = timeit(lambda p: cols_fn(p, *cargs), pos, iters=it)
    print(f"element grad columns        {t:9.1f} us", flush=True)

    cols = cols_fn(pos, *cargs)

    seg_fn = jax.jit(
        lambda c, idx: segment_assemble(
            element_contrib_full(c), idx, obj.particle_cnt
        )
    )
    t = timeit(seg_fn, cols, obj.element_indices, iters=it)
    print(f"segment assembly            {t:9.1f} us", flush=True)

    gat_fn = jax.jit(
        lambda c, g: gather_assemble(element_contrib_full(c), g)
    )
    t = timeit(gat_fn, cols, obj.gather_idx, iters=it)
    print(f"gather assembly             {t:9.1f} us  "
          f"(maxdeg={obj.gather_idx.shape[1]})", flush=True)

    grad_fn = jax.jit(lambda p, o: gather_assemble(
        element_contrib_full(
            explicit_grad_columns(
                p, o.element_indices, o.ref_inv, o.volume, obj.mu, obj.s_lambda
            )
        ), o.gather_idx))
    t = timeit(grad_fn, pos, obj, iters=it)
    print(f"gradient (fused)            {t:9.1f} us", flush=True)

    hess_fn = jax.jit(hessian_blocks, static_argnums=(4, 5))
    t = timeit(lambda p: hess_fn(p, *cargs), pos, iters=it)
    print(f"hessian blocks K            {t:9.1f} us", flush=True)

    K = hess_fn(pos, *cargs)
    apply_fn = jax.jit(lambda o, k, x: make_system_apply(o, k, dt_s)(x))
    t = timeit(apply_fn, obj, K, state.vel, iters=it)
    print(f"system apply A@x            {t:9.1f} us", flush=True)

    solve_fn = jax.jit(
        lambda o, s: implicit_velocity_solve(o, s, dt_s, 1, 1)[0].vel
    )
    t = timeit(solve_fn, obj, state, iters=it)
    print(f"full implicit solve         {t:9.1f} us", flush=True)


if __name__ == "__main__":
    main()
