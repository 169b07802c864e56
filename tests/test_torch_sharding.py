"""The port's sharding rules (``distribution/sharding.py``) against the JAX
package's (``repro/distribution/sharding.py``): ``param_shardings`` (FSDP
and serving), ``opt_state_shardings``, ``batch_sharding`` over several
batch sizes, ``activation_sharding``, ``cache_shardings`` at
``decode_32k`` and ``long_500k``, and ``shard_shape`` against
``NamedSharding.shard_shape``, for every assigned config and its
``reduced()``, on both production meshes (16 x 16 and 2 x 16 x 16) and on
the elastic meshes of dp2tp2, dp1tp4, pp2tp2 and dp1ep2tp2.

The JAX side runs once, in one subprocess with 512 host devices, and
dumps every spec as JSON; a JAX spec drops trailing ``None`` entries, so
it is padded to the leaf's dims before the comparison."""

from __future__ import annotations

import json

import pytest

from repro_torch.configs import ASSIGNED, SHAPES, get_config
from repro_torch.configs.base import ParallelConfig
from repro_torch.distribution import sharding as S
from repro_torch.launch.mesh import MeshSpec, make_production_mesh
from repro_torch.models import model as M
from repro_torch.utils.pytree import tree_paths

MESHES = {
    "pod16x16": make_production_mesh(),
    "pod2x16x16": make_production_mesh(multi_pod=True),
    "dp2tp2": S.make_elastic_mesh(ParallelConfig(dp=2, tp=2)),
    "dp1tp4": S.make_elastic_mesh(ParallelConfig(dp=1, tp=4)),
    "pp2tp2": S.make_elastic_mesh(ParallelConfig(pp=2, tp=2)),
    "dp1ep2tp2": S.make_elastic_mesh(ParallelConfig(dp=1, ep=2, tp=2)),
}
BATCHES = (1, 2, 4, 6, 16, 32, 48, 128, 256, 512)
CACHE_SHAPES = ("decode_32k", "long_500k")
CONFIGS = [(arch, red) for arch in ASSIGNED for red in (False, True)]

_JAX_DUMP = """
import json, sys
import jax
from repro.configs import ASSIGNED, SHAPES
from repro.configs.base import ParallelConfig
from repro.distribution import sharding as S
from repro.launch.mesh import make_production_mesh
from repro.models.model import abstract_params, abstract_cache
from repro.utils.pytree import tree_paths

def spec(s):
    return [list(e) if isinstance(e, tuple) else e for e in s.spec]

meshes = {
    "pod16x16": make_production_mesh(),
    "pod2x16x16": make_production_mesh(multi_pod=True),
    "dp2tp2": S.make_elastic_mesh(ParallelConfig(dp=2, tp=2)),
    "dp1tp4": S.make_elastic_mesh(ParallelConfig(dp=1, tp=4)),
    "pp2tp2": S.make_elastic_mesh(ParallelConfig(pp=2, tp=2)),
    "dp1ep2tp2": S.make_elastic_mesh(ParallelConfig(dp=1, ep=2, tp=2)),
}
out = {}
for arch, full in ASSIGNED.items():
    for red in (False, True):
        cfg = full.reduced() if red else full
        shapes = {p: x.shape for p, x in tree_paths(abstract_params(cfg)).items()}
        caches = {n: tree_paths(abstract_cache(cfg, SHAPES[n].global_batch, SHAPES[n].seq_len)) for n in CACHE}
        for mname, mesh in meshes.items():
            ps = tree_paths(S.param_shardings(cfg, mesh))
            opt = S.opt_state_shardings(cfg, mesh)
            d = {
                "params": {p: spec(s) for p, s in ps.items()},
                "serving": {p: spec(s) for p, s in tree_paths(S.param_shardings(cfg, mesh, serving=True)).items()},
                "opt_mu_nu_equal": all(tree_paths(opt[k]) == ps for k in ("mu", "nu")),
                "opt_count": spec(opt["count"]),
                "shard_shape": {p: list(s.shard_shape(shapes[p])) for p, s in ps.items()},
            }
            if not red:
                d["batch"] = {str(b): spec(S.batch_sharding(mesh, b)) for b in BATCHES}
                d["activation"] = list(S.activation_sharding(mesh))
                d["activation"] = [list(e) if isinstance(e, tuple) else e for e in d["activation"]]
            d["cache"] = {}
            d["cache_shard_shape"] = {}
            for n in CACHE:
                cs = tree_paths(S.cache_shardings(cfg, mesh, SHAPES[n].global_batch, SHAPES[n].seq_len))
                d["cache"][n] = {p: spec(s) for p, s in cs.items()}
                d["cache_shard_shape"][n] = {p: list(s.shard_shape(caches[n][p].shape)) for p, s in cs.items()}
            out[f"{arch}|{int(red)}|{mname}"] = d
print("JSON" + json.dumps(out))
"""


def _norm(entry):
    return tuple(entry) if isinstance(entry, list) else entry


def _pad(spec, ndim: int) -> tuple:
    spec = tuple(_norm(e) for e in spec)
    return spec + (None,) * (ndim - len(spec))


@pytest.fixture(scope="module")
def jax_specs(subproc):
    code = f"CACHE = {CACHE_SHAPES!r}\nBATCHES = {BATCHES!r}\n" + _JAX_DUMP
    out = subproc(code, n_devices=512, timeout=600)
    return json.loads(out.split("JSON", 1)[1])


def _cfg(arch: str, red: bool):
    cfg = get_config(arch)
    return cfg.reduced() if red else cfg


@pytest.mark.parametrize("arch,red", CONFIGS)
def test_param_and_opt_specs_equal_jax(jax_specs, arch, red):
    cfg = _cfg(arch, red)
    shapes = {p: tuple(x.shape) for p, x in tree_paths(M.abstract_params(cfg)).items()}
    for mname, mesh in MESHES.items():
        want = jax_specs[f"{arch}|{int(red)}|{mname}"]
        for serving, key in ((False, "params"), (True, "serving")):
            ours = tree_paths(S.param_shardings(cfg, mesh, serving=serving))
            assert set(ours) == set(want[key])
            for p, spec in ours.items():
                assert spec == _pad(want[key][p], len(shapes[p])), (mname, key, p)
        opt = S.opt_state_shardings(cfg, mesh)
        assert want["opt_mu_nu_equal"]
        assert tree_paths(opt["mu"]) == tree_paths(opt["nu"]) == tree_paths(S.param_shardings(cfg, mesh))
        assert opt["count"] == _pad(want["opt_count"], 0) == ()


@pytest.mark.parametrize("arch,red", CONFIGS)
def test_shard_shape_equals_named_sharding(jax_specs, arch, red):
    cfg = _cfg(arch, red)
    params = tree_paths(M.abstract_params(cfg))
    for mname, mesh in MESHES.items():
        want = jax_specs[f"{arch}|{int(red)}|{mname}"]["shard_shape"]
        for p, spec in tree_paths(S.param_shardings(cfg, mesh)).items():
            assert S.shard_shape(params[p].shape, spec, mesh) == tuple(want[p]), (mname, p)
            n = params[p].numel() // (mesh.size // _replicas(spec, mesh))
            assert S.shard_bytes(params[p], spec, mesh) == n * params[p].element_size()


def _replicas(spec, mesh: MeshSpec) -> int:
    """The chips that hold the same shard: the mesh over the spec's axes."""
    used = [a for e in spec if e is not None for a in ((e,) if isinstance(e, str) else e)]
    n = 1
    for a in used:
        n *= mesh.axis_size(a)
    return mesh.size // n


@pytest.mark.parametrize("arch,red", CONFIGS)
def test_cache_specs_and_shard_shapes_equal_jax(jax_specs, arch, red):
    cfg = _cfg(arch, red)
    for mname, mesh in MESHES.items():
        want = jax_specs[f"{arch}|{int(red)}|{mname}"]
        for n in CACHE_SHAPES:
            shape = SHAPES[n]
            cache = tree_paths(M.abstract_cache(cfg, shape.global_batch, shape.seq_len))
            ours = tree_paths(S.cache_shardings(cfg, mesh, shape.global_batch, shape.seq_len))
            assert set(ours) == set(want["cache"][n]) == set(cache)
            for p, spec in ours.items():
                assert spec == _pad(want["cache"][n][p], cache[p].dim()), (mname, n, p)
                assert S.shard_shape(cache[p].shape, spec, mesh) == tuple(want["cache_shard_shape"][n][p])


@pytest.mark.parametrize("mname", list(MESHES))
def test_batch_and_activation_specs_equal_jax(jax_specs, mname):
    mesh = MESHES[mname]
    want = jax_specs[f"qwen3-1.7b|0|{mname}"]
    for b in BATCHES:
        for ndim in (1, 2, 3):
            assert S.batch_sharding(mesh, b, ndim) == _pad(want["batch"][str(b)], ndim), (b, ndim)
    assert S.activation_sharding(mesh) == _pad(want["activation"], 1)


def test_shard_shape_refuses_what_does_not_divide():
    mesh = make_production_mesh()
    assert S.shard_shape((32, 48), (("data",), "model"), mesh) == (2, 3)
    assert S.shard_shape((32, 48, 5), ("data",), mesh) == (2, 48, 5)
    with pytest.raises(ValueError, match="does not divide"):
        S.shard_shape((24, 48), ("data", None), mesh)
    with pytest.raises(ValueError, match="more entries"):
        S.shard_shape((16,), (None, "model"), mesh)
    assert mesh.describe() == "pod16x16" and make_production_mesh(multi_pod=True).size == 512
