# coding=utf-8
"""Measure the contact broad phase: dense pair matrices vs the uniform
grid (fem_tpu/broadphase.py) across participating-vertex counts.

Synthetic surface-like soup: two interpenetrating shells of ns/2 vertices
each at ~contact-radius spacing (the density the auto-radius rule
produces), plus a same-body self-contact variant.  Times one force
evaluation per mode, ending each timed region with a device->host fetch.

Usage: python tools/probe_broadphase.py [--sizes 2048,8192,24576]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def sphere_shell(n, center, r, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return (center + r * v).astype(np.float32)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--sizes", default="2048,8192,24576")
    p.add_argument("--cap", type=int, default=8)
    p.add_argument("--reps", type=int, default=30)
    args = p.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from fem_tpu.broadphase import grid_contact_forces, grid_overflow_count
    from fem_tpu.contact import pair_contact_forces

    print(f"backend: {jax.default_backend()}", file=sys.stderr)

    for ns in [int(s) for s in args.sizes.split(",")]:
        half = ns // 2
        # Shell radius so that surface spacing ~ sqrt(4*pi*r^2/half);
        # contact radius = that spacing (the auto rule).
        shell_r = 0.2
        spacing = float(np.sqrt(4 * np.pi * shell_r**2 / half))
        radius = spacing
        a = sphere_shell(half, np.array([0.45, 0.5, 0.5]), shell_r, 0)
        b = sphere_shell(
            half, np.array([0.45 + 2 * shell_r - 2 * radius, 0.5, 0.5]),
            shell_r, 1,
        )
        pos = np.concatenate([a, b])
        body = np.concatenate(
            [np.zeros(half, np.int32), np.ones(half, np.int32)]
        )
        k = 1e3
        ov = grid_overflow_count(pos, radius, args.cap)
        posj, bodyj = jnp.asarray(pos), jnp.asarray(body)

        grid_fn = jax.jit(
            lambda p_, b_: grid_contact_forces(
                p_, b_, p_, radius, k, cap=args.cap
            )
        )
        f = grid_fn(posj, bodyj)
        np.asarray(f)
        t0 = time.perf_counter()
        for _ in range(args.reps):
            f = grid_fn(posj, bodyj)
        s_grid = np.asarray(f).sum()
        t_grid = (time.perf_counter() - t0) / args.reps

        aj, bj = jnp.asarray(a), jnp.asarray(b)
        dense_fn = jax.jit(
            lambda pa, pb: pair_contact_forces(pa, pb, radius, k)
        )
        try:
            fa, fb = dense_fn(aj, bj)
            np.asarray(fa)
            t0 = time.perf_counter()
            for _ in range(args.reps):
                fa, fb = dense_fn(aj, bj)
            s_dense = np.asarray(fa).sum() + np.asarray(fb).sum()
            t_dense = (time.perf_counter() - t0) / args.reps
            dense_str = f"{t_dense*1e3:.2f} ms"
        except Exception as exc:  # OOM at scale is the expected outcome
            dense_str = f"FAILED ({type(exc).__name__})"
            s_dense = float("nan")
        print(
            f"ns={ns} radius={radius:.4f} overflow_cells={ov}: "
            f"grid {t_grid*1e3:.2f} ms | dense(pair) {dense_str} "
            f"(checksums {s_grid:.3f} / {s_dense:.3f})"
        )


if __name__ == "__main__":
    main()
