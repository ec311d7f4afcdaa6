# coding=utf-8
"""The execution-strategy chooser, rejected legacy options, the compile
cache location, the pytree helper, the import footprint of the main path,
and chip_smoke.py's phases run as functions at tiny sizes."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest

from fem_tpu import strategy
from fem_tpu.utils.config import parse_config
from tests.utils import make_2d_object

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- strategy ----------------------------------------------------------------

@pytest.mark.parametrize(
    "mode,elements,particles,want",
    [
        ("auto", 200, 121, False),
        ("graph", 200, 121, False),
        ("mxu", 200, 121, True),
        ("mxu", 100_000, 20_000, False),  # S would exceed its size cap
    ],
)
def test_builds_edge_matrix(mode, elements, particles, want):
    assert strategy.builds_edge_matrix(mode, elements, particles, 3) is want


@pytest.mark.parametrize(
    "mode,has_matrix,axis_name,want",
    [
        ("auto", False, None, "graph"),
        ("graph", True, None, "graph"),
        ("mxu", True, None, "mxu"),
        ("auto", True, None, "mxu"),
        ("mxu", False, None, "graph"),
        ("mxu", True, "elem", "graph"),  # sharded: always the graph operator
    ],
)
def test_implicit_operator(mode, has_matrix, axis_name, want):
    _, obj, _ = make_2d_object(subdivisions=2)
    if not has_matrix:
        obj = obj.replace(edge_matrix=None)
    else:
        from tests.utils import attach_edge_matrix

        obj = attach_edge_matrix(obj)
    assert strategy.implicit_operator(mode, obj, axis_name) == want


@pytest.mark.parametrize("mode", ["blocked", "fused", "pallas"])
def test_implicit_operator_rejects_unknown_modes(mode):
    _, obj, _ = make_2d_object(subdivisions=2)
    with pytest.raises(ValueError, match="operator_mode"):
        strategy.implicit_operator(mode, obj)


@pytest.mark.parametrize(
    "backend,kw,want",
    [
        ("auto", {}, False),
        ("dense", {}, True),
        ("dense", {"sharded": True}, False),
        ("dense", {"hessian": "exact_jvp"}, False),
        ("dense", {"inelastic": True}, False),
        ("dense", {"constrained": True}, False),
    ],
)
def test_uses_dense_solver(backend, kw, want):
    args = dict(sharded=False, hessian="reference", cg_precond="reference",
                inelastic=False, constrained=False)
    args.update(kw)
    assert strategy.uses_dense_solver(backend, **args) is want


# -- removed options -----------------------------------------------------------

REMOVED = [
    {"frame_backend": "auto"},
    {"element_backend": "xla"},
    {"cg_fast_math": False},
    {"operator_mode": "blocked"},
    {"operator_mode": "fused"},
]


@pytest.mark.parametrize("entry", REMOVED, ids=lambda e: "-".join(
    f"{k}={v}" for k, v in e.items()))
def test_removed_options_rejected_when_read(entry):
    with open(os.path.join(ROOT, "configs", "default.json")) as fh:
        data = json.load(fh)
    data.update(entry)
    with pytest.raises(ValueError):
        parse_config(data)


def test_cli_exits_3_on_removed_option(tmp_path):
    import main as cli

    with open(os.path.join(ROOT, "configs", "default.json")) as fh:
        data = json.load(fh)
    data["element_backend"] = "pallas"
    path = tmp_path / "bad.json"
    path.write_text(json.dumps(data))
    assert cli.run(["--config", str(path), "--no-render", "--frames", "1",
                    "--output", str(tmp_path)]) == 3


# -- compile cache ------------------------------------------------------------

@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_defaults_inside_checkout(monkeypatch,
                                                restore_cache_dir):
    from fem_tpu.utils import runtime

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = runtime.enable_compile_cache()
    assert path == os.path.join(ROOT, ".cache", "jax")
    assert jax.config.jax_compilation_cache_dir == path


def test_compile_cache_honours_environment(monkeypatch, tmp_path,
                                           restore_cache_dir):
    from fem_tpu.utils import runtime

    jax.config.update("jax_compilation_cache_dir", None)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert runtime.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir is None  # code set nothing


# -- pytree helper ------------------------------------------------------------

def test_pytree_dataclass_leaves_and_static_fields():
    from fem_tpu.utils.pytree import dataclass, static_field

    @dataclass
    class Box:
        x: jnp.ndarray
        y: jnp.ndarray = None
        n: int = static_field(3)

    b = Box(x=jnp.ones(2))
    leaves, tree = jax.tree_util.tree_flatten(b)
    assert len(leaves) == 1  # None is no leaf, n is static
    b2 = b.replace(n=4, y=jnp.zeros(1))
    assert (b.n, b2.n) == (3, 4) and b2.y.shape == (1,)
    assert jax.tree_util.tree_structure(b2) != tree
    with pytest.raises(Exception):
        b.x = jnp.zeros(2)  # frozen


def test_pytree_static_field_is_trace_constant():
    from fem_tpu.utils.pytree import dataclass, static_field

    @dataclass
    class Scaled:
        x: jnp.ndarray
        k: float = static_field(2.0)

    calls = []

    @jax.jit
    def f(s):
        calls.append(s.k)  # runs only while tracing
        return s.x * s.k

    assert float(f(Scaled(jnp.ones(())))) == 2.0
    assert float(f(Scaled(jnp.ones(()), k=3.0))) == 3.0
    assert calls == [2.0, 3.0]


# -- the main path's imports --------------------------------------------------

def test_main_path_imports_no_optional_packages(tmp_path):
    """``main.py --no-render`` and ``fem_tpu.Simulation`` need nothing
    beyond JAX, numpy, scipy and the standard library."""
    code = (
        "import sys, main, fem_tpu\n"
        f"assert main.run(['--config', 'configs/default.json', "
        f"'--no-render', '--frames', '1', '--output', {str(tmp_path)!r}]) "
        "== 0\n"
        "bad = [m for m in ('flax', 'matplotlib', 'imageio', 'PIL', 'optax',"
        " 'chex', 'einops') if m in sys.modules]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]


# -- chip_smoke.py ------------------------------------------------------------

def test_chip_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


def test_chip_smoke_main_refuses_cpu_in_process(capsys):
    import chip_smoke

    assert chip_smoke.main([]) == 2
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.parametrize("config,frames", [
    ("configs/default.json", 3),
    ("configs/demo_spot.json", 2),
])
def test_chip_smoke_cli_phase(config, frames, tmp_path):
    import chip_smoke

    r = chip_smoke.phase_cli(config, frames, str(tmp_path))
    assert r["frames"] == frames and r["compile_s"] > 0
    assert r["steps_per_s"] > 0
    if "spot" in config:
        assert r["obj_files"] >= 1


@pytest.mark.parametrize("method", ["explicit", "autodiff", "jacobi"])
def test_chip_smoke_simulation_phase(method):
    import chip_smoke

    with open(os.path.join(ROOT, "configs", "default.json")) as fh:
        data = json.load(fh)
    r = chip_smoke.phase_simulation(data, method, warm=1, frames=1)
    assert r["steps_per_s"] > 0 and not r["metrics"].any_nan


def test_chip_smoke_large_phase_tiny():
    import chip_smoke

    r = chip_smoke.phase_large(subdivisions=3, warm=1, frames=1,
                               compare_substeps=2)
    assert r["tets"] == 6 * 27
    assert set(r["variants"]) == {"precond1", "plain"}
    assert r["vs_cpu"]["pos"] <= chip_smoke.DEVICE_POS_ATOL


def test_chip_smoke_parity_phase_tiny():
    import chip_smoke
    from fem_tpu.models.mesh import construct_3d_grid_mesh
    from fem_tpu.utils.config import ObjectConfig

    ocfg = ObjectConfig(center=(0.35, 0.3, 0.35), side_length=0.3,
                        subdivisions=2, rho=1000.0, E=4e4, nu=0.4,
                        damping=10.0)
    v, f, e = construct_3d_grid_mesh(ocfg)
    r = chip_smoke.phase_parity(ocfg, v, f, e)
    assert set(r) == set(chip_smoke.PARITY_METHODS)
    for name, pr in r.items():
        assert pr["max_pos_err"] <= pr["atol"], name


def test_chip_smoke_sharded_phase_tiny():
    import chip_smoke

    r = chip_smoke.phase_sharded(n_devices=4, subdivisions=3, warm=1,
                                 frames=1)
    assert r["devices"] == 4
    assert r["vs_single"]["pos"] <= 10 * chip_smoke.DEVICE_POS_ATOL


@pytest.mark.gpu
def test_flagship_parity_on_gpu(gpu_devices):
    """Every method on the flagship mesh against the float64 oracle, on the
    card (chip_smoke.py phase (e))."""
    import chip_smoke

    os.chdir(ROOT)
    r = chip_smoke.phase_parity(*chip_smoke.flagship_mesh())
    assert all(pr["max_pos_err"] <= pr["atol"] for pr in r.values())
