# coding=utf-8
"""Smoke tests: every shipped example runs end-to-end.

The examples are user-facing documentation (README points at them); these
tests keep them from rotting.  Each runs as a subprocess with
FEM_TPU_EXAMPLE_FAST=1 (same code paths, tiny frame/iteration counts) and
JAX_PLATFORMS=cpu (subprocesses don't inherit conftest).
"""

import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _run(script, *args):
    env = dict(os.environ)
    env["FEM_TPU_EXAMPLE_FAST"] = "1"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, env.get("PYTHONPATH")) if p
    )
    return subprocess.run(
        [sys.executable, script],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600,
    )


@pytest.mark.parametrize(
    "script,expect",
    [
        ("examples/library_usage.py", "min det F"),
        ("examples/ensemble_sweep.py", "members through the passage"),
        ("examples/inverse_material.py", "recovered E"),
        ("examples/two_body_contact.py", "two_body_contact OK"),
        ("examples/static_sag.py", "dynamic drift off the static"),
        ("examples/modal_modes.py", "natural frequencies (Hz):"),
        ("examples/newton_large_dt.py", "newton_large_dt OK"),
        ("examples/stability_analysis.py", "peak at"),
        ("examples/anisotropic_fibers.py", "anisotropic_fibers OK"),
        ("examples/plasticity_demo.py", "permanent"),
        ("examples/viscoelastic_relaxation.py", "relaxation timescale matches"),
        ("examples/inverse_yield.py", "inverse_yield OK"),
    ],
)
def test_example_runs(script, expect):
    res = _run(os.path.join(ROOT, script))
    assert res.returncode == 0, res.stderr[-2000:]
    assert expect in res.stdout, res.stdout[-2000:]
