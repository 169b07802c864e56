"""The port's copies and rules: configs equal to the JAX package's, the
param layout and its converter, the package's isolation from JAX, and the
serving CLI."""

from __future__ import annotations

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import model as JM
from repro.utils.pytree import tree_paths as jax_tree_paths
from repro_torch import configs
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_jax
from repro_torch.utils.pytree import tree_from_paths, tree_map_with_path, tree_paths

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
ENV = {**os.environ, "PYTHONPATH": str(REPO / "src")}
# the families the port runs: dense decoders and mamba2 (ssm)
PORTED = sorted(n for n, c in configs.REGISTRY.items() if c.family in ("dense", "ssm"))


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(jax_configs.REGISTRY))
def test_config_equals_jax(name):
    port, ref = configs.get_config(name), jax_configs.get_config(name)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(port.reduced()) == dataclasses.asdict(ref.reduced())
    assert port.subquadratic == ref.subquadratic
    assert [port.layer_kind(i) for i in range(port.num_layers)] == [
        ref.layer_kind(i) for i in range(ref.num_layers)
    ]


def test_registry_shapes_and_parallel_config_equal_jax():
    assert sorted(configs.REGISTRY) == sorted(jax_configs.REGISTRY)
    assert sorted(configs.ASSIGNED) == sorted(jax_configs.ASSIGNED)
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jax_configs.SHAPES.items()
    }
    for name in configs.REGISTRY:
        for shape in configs.SHAPES:
            assert configs.shape_applicable(configs.get_config(name), shape) == jax_configs.shape_applicable(
                jax_configs.get_config(name), shape
            )
    for dims in [(2, 1, 2, 1), (1, 2, 2, 2), (4, 2, 1, 1)]:
        port, ref = configs.ParallelConfig(*dims), jax_configs.ParallelConfig(*dims)
        assert port.describe() == ref.describe()
        for r in range(port.world_size):
            assert port.rank_coords(r) == ref.rank_coords(r)
            assert port.coords_rank(*port.rank_coords(r)) == r
    train = configs.TrainConfig(configs.get_config("qwen3-1.7b"))
    assert dataclasses.asdict(train) == dataclasses.asdict(jax_configs.TrainConfig(jax_configs.get_config("qwen3-1.7b")))
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("nope")


@pytest.mark.parametrize("name", ["qwen3-1.7b", "gemma-7b", "qwen2.5-14b"])
def test_param_count_and_paths_equal_jax(name):
    """Full-width shapes from the meta device against the JAX package's
    abstract params: same paths, same shapes, same count."""
    port, ref = configs.get_config(name), jax_configs.get_config(name)
    want = {p: tuple(x.shape) for p, x in jax_tree_paths(JM.abstract_params(ref)).items()}
    assert M.param_shapes(port) == want
    assert port.param_count() == ref.param_count()
    assert port.active_param_count() == ref.active_param_count()


@pytest.mark.parametrize("name", PORTED)
def test_reduced_init_layout_equals_jax(name):
    port, ref = configs.get_config(name).reduced(), jax_configs.get_config(name).reduced()
    want = {p: (tuple(x.shape), str(x.dtype)) for p, x in jax_tree_paths(JM.init_params(ref, jax.random.key(0))).items()}
    got = M.init_params(port, torch.Generator().manual_seed(0), "cpu")
    assert {p: (tuple(x.shape), str(x.dtype).removeprefix("torch.")) for p, x in tree_paths(got).items()} == want


@pytest.mark.parametrize("name", ["mixtral-8x7b", "jamba-v0.1-52b", "seamless-m4t-large-v2"])
def test_unported_families_raise(name):
    cfg = configs.get_config(name).reduced()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        M.init_params(cfg, device="meta")
    with pytest.raises(NotImplementedError, match="not ported"):
        cfg.param_count()


# ---------------------------------------------------------------------------
# init, params_from_jax, pytree
# ---------------------------------------------------------------------------


def test_init_params_is_seeded_with_the_jax_distributions():
    cfg = configs.get_config("qwen3-1.7b").reduced()
    a = tree_paths(M.init_params(cfg, torch.Generator().manual_seed(3), "cpu"))
    b = tree_paths(M.init_params(cfg, torch.Generator().manual_seed(3), "cpu"))
    c = tree_paths(M.init_params(cfg, torch.Generator().manual_seed(4), "cpu"))
    assert all(torch.equal(a[p], b[p]) for p in a)
    assert not torch.equal(a["blocks/pos0/mixer/wq"], c["blocks/pos0/mixer/wq"])
    d, f = cfg.d_model, cfg.d_ff
    assert abs(a["embed/tok"].std().item() - 0.02) < 0.002
    assert abs(a["blocks/pos0/mlp/wi_gate"].std().item() - d**-0.5) < 0.1 * d**-0.5
    assert abs(a["blocks/pos0/mlp/wo"].std().item() - f**-0.5) < 0.1 * f**-0.5
    assert abs(a["blocks/pos0/mixer/wq"].mean().item()) < 0.01
    assert torch.equal(a["final_norm/scale"], torch.ones(d))
    assert torch.equal(a["blocks/pos0/mixer/q_norm"], torch.ones(cfg.num_layers, cfg.resolved_head_dim))


def _jax_flat(cfg_name="qwen3-1.7b"):
    ref = jax_configs.get_config(cfg_name).reduced()
    return {p: np.asarray(x) for p, x in jax_tree_paths(JM.init_params(ref, jax.random.key(0))).items()}


def test_params_from_jax_carries_values():
    cfg = configs.get_config("qwen3-1.7b").reduced()
    flat = _jax_flat()
    params = params_from_jax(flat, cfg, "cpu")
    got = tree_paths(params)
    assert got.keys() == flat.keys()
    for p in flat:
        np.testing.assert_array_equal(got[p].numpy(), flat[p])
    half = tree_paths(params_from_jax(flat, cfg, "cpu", dtype=torch.bfloat16))
    assert half["embed/tok"].dtype == torch.bfloat16


@pytest.mark.parametrize("fault", ["missing", "extra", "misshaped"])
def test_params_from_jax_rejects_a_bad_leaf(fault):
    cfg = configs.get_config("qwen3-1.7b").reduced()
    flat = _jax_flat()
    if fault == "missing":
        del flat["blocks/pos0/mixer/k_norm"]
    elif fault == "extra":
        flat["blocks/pos0/mixer/bq"] = np.zeros((4, 64), np.float32)
    else:
        flat["lm_head/w"] = flat["lm_head/w"][:, :-1]
    with pytest.raises(ValueError, match=fault.replace("misshaped", "mis-shaped") + r" \['"):
        params_from_jax(flat, cfg, "cpu")


def test_pytree_paths_round_trip_like_jax():
    tree = {"b": {"y": np.zeros(2), "x": {"z": np.ones(1)}}, "a": np.zeros(3)}
    flat = tree_paths(tree)
    assert list(flat) == list(jax_tree_paths(tree))  # the same names in the same order
    back = tree_from_paths(flat)
    assert tree_paths(back).keys() == flat.keys()
    doubled = tree_map_with_path(lambda p, x: x + (p == "a"), tree)
    np.testing.assert_array_equal(doubled["a"], np.ones(3))


def test_init_cache_matches_jax_layout():
    for name in ["qwen3-1.7b", "gemma-7b"]:
        port = configs.get_config(name).reduced()
        ref = jax_configs.get_config(name).reduced()
        got = tree_paths(M.init_cache(port, 2, 40, torch.float32, "cpu"))
        want = jax_tree_paths(JM.abstract_cache(ref, 2, 40, jnp.float32))
        assert {p: tuple(x.shape) for p, x in got.items()} == {p: tuple(x.shape) for p, x in want.items()}
        assert all(not x.any() for x in got.values())


def test_cuda_requests_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = configs.get_config("qwen3-1.7b").reduced()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        M.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        M.init_cache(cfg, 1, 8)


# ---------------------------------------------------------------------------
# isolation: the port and chip_smoke.py import neither jax nor repro
# ---------------------------------------------------------------------------

_FORBIDDEN_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)", re.M)

# the reshard data plane and elastic serving (kept by name, so that a module
# that went missing cannot leave the isolation checks unnoticed)
RESHARD_AND_ELASTIC_SERVE = [
    "core/errors", "core/events", "core/records", "core/resource_view", "core/intersection",
    "core/reshard", "core/shadow", "core/world_pool", "reshard/wire", "reshard/chunking",
    "reshard/engine", "reshard/executors", "kernels/reshard_pack", "serve/cache_view",
    "serve/slots", "serve/world", "serve/controller", "serve/loop",
]
# live-resized training and the compressed wire
TRAINING = [
    "optim/adamw", "data/pipeline", "distribution/step", "core/generations", "core/downtime",
    "core/controller", "reshard/overlap", "kernels/reshard_quant", "launch/train",
]
# serving mamba2: the SSM mixer and the last two kernels
SSM = ["models/ssm", "kernels/ssd_scan", "kernels/rmsnorm"]
# the controller's lifecycle: the H100's constants, the topology search and
# the operating-point tuner
LIFECYCLE = ["launch/mesh", "core/topology_search", "reshard/autotune"]
# the elastic control plane, with the simulator, roofline and fleet modules
# it imports
CONTROL_PLANE = [
    "elastic/protocol", "elastic/trace", "elastic/endpoint", "elastic/scheduler", "sim/des", "sim/cluster",
    "sim/liver_sim", "sim/volatility", "roofline/analysis", "fleet/policies", "fleet/arbiter",
]


def test_port_sources_do_not_import_jax_or_repro():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    assert {PORT / f"{m}.py" for m in RESHARD_AND_ELASTIC_SERVE + TRAINING + SSM + LIFECYCLE + CONTROL_PLANE} <= set(files)
    offenders = [f"{f}: {m.group(0).strip()}" for f in files for m in _FORBIDDEN_IMPORT.finditer(f.read_text())]
    assert offenders == []


def test_importing_the_port_loads_no_jax():
    wanted = [f"repro_torch.{m.replace('/', '.')}" for m in RESHARD_AND_ELASTIC_SERVE + TRAINING + SSM + LIFECYCLE + CONTROL_PLANE]
    code = f"""
import importlib, pkgutil, sys
sys.path.insert(0, {str(REPO)!r})
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
missing = sorted(set({wanted!r}) - set(names))
assert not missing, missing
assert len(names) >= 89, names
print("ok", len(names))
"""
    out = subprocess.run([sys.executable, "-c", code], env=ENV, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _serve_cli(*extra):
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "qwen3-1.7b", "--reduced",
           "--batch", "2", "--prompt-len", "32", "--gen", "4", *extra]
    return subprocess.run(cmd, env=ENV, capture_output=True, text=True, timeout=120, cwd=REPO)


def test_serve_cli_runs_on_cpu():
    out = _serve_cli("--device", "cpu")
    assert out.returncode == 0, out.stderr
    assert "[prefill] 2x32 tokens" in out.stdout and "[decode] 4 steps x batch 2" in out.stdout


def test_serve_cli_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _serve_cli("--device", "cuda")
    assert out.returncode != 0
    assert "CUDA" in out.stderr and "[prefill]" not in out.stdout
