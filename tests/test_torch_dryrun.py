"""The port's dry run (``launch/dryrun.py``) and what it reads: the meta
routes of the kernels (``kernels/meta.py``), their work formulas
(``kernels/work.py``) and the counting mode (``roofline/counting.py``).

- The per-chip argument bytes of reduced qwen3's train and decode steps on
  a (data 2, model 16) mesh equal ``compiled.memory_analysis()
  .argument_size_in_bytes`` of the JAX steps built as the JAX dry run's
  ``_lower_cell`` builds them (one subprocess, 32 host devices), but for
  the leaves XLA counts otherwise, named with their difference: the port's
  tokens are int64 (the JAX package's int32), and its decode position is a
  host int (the JAX package's a 4-byte scalar array).
- The reduced dense step's FLOPs equal a closed form exactly, and the
  counts at 1, 2 and 4 periods are exactly linear (the JAX probe model's
  premise).
- The meta routes record their kernel's formula and return the right
  output and gradient shapes; no kernel launches.
- A one-cell ``--sweep`` writes the JSON with the JAX keys; ``long_500k``
  is skipped for a full-attention arch; CUDA is not initialised."""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.distribution.step import init_opt_state, make_train_step
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import meta, ops, work
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import MeshSpec
from repro_torch.models import model as M
from repro_torch.models.transformer import block_program
from repro_torch.optim import AdamWConfig
from repro_torch.roofline.counting import count

REPO = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(REPO / "src")}
MESH_2x16 = MeshSpec(("data", "model"), (2, 16))
TRAIN = ShapeConfig("t", 64, 4, "train")
DECODE = ShapeConfig("d", 64, 4, "decode")

_JAX_ARGS = """
import json
import jax
from repro.configs import get_config
from repro.configs.base import ShapeConfig
jax.devices()  # 32 host devices, before the dry-run module sets its own flag
from repro.launch.dryrun import _lower_cell
mesh = jax.make_mesh((2, 16), ("data", "model"))
cfg = get_config("qwen3-1.7b").reduced()
out = {}
for shape in (ShapeConfig("t", 64, 4, "train"), ShapeConfig("d", 64, 4, "decode")):
    jitted, args, used = _lower_cell(cfg, shape, mesh, {})
    out[shape.kind] = jitted.lower(*args).compile().memory_analysis().argument_size_in_bytes
print("JSON" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_argument_bytes(subproc):
    return json.loads(subproc(_JAX_ARGS, n_devices=32, timeout=300).split("JSON", 1)[1])


@pytest.mark.parametrize("shape", [TRAIN, DECODE], ids=["train", "decode"])
def test_argument_bytes_equal_xla(jax_argument_bytes, shape):
    cfg = get_config("qwen3-1.7b").reduced()
    _, _, per_chip, _ = D.build_cell(cfg, shape, MESH_2x16, {})
    # the leaves XLA counts otherwise: int64 tokens here (int32 in the JAX
    # step), sharded over data 2; the JAX decode step's position, a 4-byte
    # replicated scalar the port passes as a host int
    tokens = shape.global_batch * (shape.seq_len if shape.kind == "train" else 1) // 2
    differences = {"batch/tokens": tokens * (8 - 4), "pos": -4 if shape.kind == "decode" else 0}
    assert per_chip["batch/tokens"] == tokens * 8
    assert sum(per_chip.values()) - sum(differences.values()) == jax_argument_bytes[shape.kind]


def _dense_closed_form(cfg, b: int, s: int) -> int:
    """The reduced dense train step's FLOPs: every linear layer's product
    forward, again in the rematerialised forward and twice backward (input
    and weight gradients), but for the period's last product, whose output
    the backward does not need (``torch.utils.checkpoint`` stops its
    recomputation early); the head's once forward and twice backward; the
    flash kernels' records (two forward launches and one backward launch a
    layer, ``work.flash_*_work`` on the route of the config's dtype)."""
    d, f, V, L = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.num_layers
    h, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    T = b * s
    layer = 2 * T * d * (h * hd + 2 * kh * hd) + 2 * T * h * hd * d + 3 * 2 * T * d * f
    head = 2 * T * d * V
    dims = (b, s, s, h, kh, hd, True, cfg.sliding_window, 4)
    route = fa.route(torch.float32, hd)
    fwd, _ = work.flash_fwd_work(*dims, route, lse=True)
    bwd, _ = work.flash_bwd_work(*dims, route)
    down = 2 * T * f * d  # not recomputed
    return L * (4 * layer - down + 2 * fwd + bwd) + 3 * head


def _train_count(cfg, b=2, s=64):
    params = M.abstract_params(cfg)
    opt = init_opt_state(params)
    batch = M.input_specs(cfg, ShapeConfig("x", s, b, "train"))
    _, c = count(make_train_step(cfg, AdamWConfig()), params, opt, batch)
    return c


def test_dense_step_flops_equal_the_closed_form():
    cfg = get_config("qwen3-1.7b").reduced()
    c = _train_count(cfg)
    assert c.flops == _dense_closed_form(cfg, 2, 64)
    assert c.kernels["flash_attention"]["launches"] == 2 * cfg.num_layers
    assert c.kernels["flash_attention_bwd"]["launches"] == cfg.num_layers
    assert c.bytes > c.kernel_bytes > 0 and c.peak_bytes > 0


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-2.7b", "mixtral-8x7b"])
def test_counts_are_linear_in_periods(arch):
    cfg = get_config(arch).reduced()
    period = len(block_program(cfg))
    counts = {n: _train_count(dataclasses.replace(cfg, num_layers=period * n)) for n in (1, 2, 4)}
    for key in ("flops", "bytes", "aten_flops", "aten_bytes", "kernel_flops", "kernel_bytes", "ops"):
        x1, x2, x4 = (getattr(counts[n], key) for n in (1, 2, 4))
        assert x4 == x1 + 3 * (x2 - x1), (key, x1, x2, x4)
        assert x2 > x1


def _brute_pairs_and_tiles(s, t, causal, window, bq, bk):
    qpos = np.arange(s)[:, None] + (t - s)
    kpos = np.arange(t)[None, :]
    mask = kpos <= qpos if causal else np.ones((s, t), bool)
    if window > 0:
        mask &= kpos > qpos - window
    tiles = 0
    for q0 in range(0, s, bq):
        rows = mask[q0 : q0 + bq]
        first = min(np.flatnonzero(r)[0] for r in rows if r.any())
        last = max(np.flatnonzero(r)[-1] for r in rows if r.any())
        tiles += last // bk - first // bk + 1
    return int(mask.sum()), tiles


@pytest.mark.parametrize("s,t,causal,window", [(100, 100, True, 0), (64, 200, True, 0), (130, 130, True, 40),
                                               (96, 96, False, 0), (50, 70, False, 16), (256, 256, True, 64)])
def test_pairs_and_tiles_equal_the_mask(s, t, causal, window):
    for bq, bk in ((64, 64), (128, 128), (32, 32), (128, 64)):
        pairs, tiles = _brute_pairs_and_tiles(s, t, causal, window, bq, bk)
        assert work.attended_pairs(s, t, causal, window) == pairs
        assert work.flash_tiles(s, t, causal, window, bq, bk) == tiles


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 128), (torch.bfloat16, 64), (torch.float32, 16)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 48), (False, 0)])
def test_flash_meta_route_records_the_kernel_and_shapes(dtype, d, causal, window):
    b, s, h, kh = 2, 160, 4, 2
    q = torch.empty((b, s, h, d), dtype=dtype, device="meta", requires_grad=True)
    k = torch.empty((b, s, kh, d), dtype=dtype, device="meta", requires_grad=True)
    v = torch.empty_like(k, requires_grad=True)
    before = (fa.launches, fa.bwd_launches)
    with work.recording() as rec:
        out = ops.flash_attention(q, k, v, causal=causal, window=window)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), torch.empty_like(out))
    assert (fa.launches, fa.bwd_launches) == before
    assert out.shape == q.shape and out.dtype == dtype and out.device.type == "meta"
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    dims = (b, s, s, h, kh, d, causal, window, q.element_size())
    route = fa.route(dtype, d)
    assert rec == [work.KernelWork("flash_attention", *work.flash_fwd_work(*dims, route, lse=True)),
                   work.KernelWork("flash_attention_bwd", *work.flash_bwd_work(*dims, route))]
    # the kernel visits whole tiles: at least the bound's products
    assert rec[0].flops >= work.flash_fwd_bound(*dims)[0] and rec[1].flops >= work.flash_bwd_bound(*dims)[0]
    with work.recording() as rec:  # no gradient asked for: no log-sum-exp written
        ops.flash_attention(q.detach(), k.detach(), v.detach(), causal=causal, window=window)
    assert rec[0].bytes == work.flash_fwd_bound(*dims)[1]


def test_ssd_and_rmsnorm_meta_routes_record_the_kernel_and_shapes():
    b, s, h, p, n, chunk = 2, 100, 4, 64, 16, 32
    x = torch.empty((b, s, h, p), device="meta", requires_grad=True)
    dt = torch.empty((b, s, h), device="meta", requires_grad=True)
    A = torch.empty((h,), device="meta", requires_grad=True)
    B = torch.empty((b, s, n), device="meta", requires_grad=True)
    C = torch.empty((b, s, n), device="meta", requires_grad=True)
    with work.recording() as rec:
        y, final = ops.ssd_scan(x, dt, A, B, C, chunk)
        grads = torch.autograd.grad((y, final), (x, dt, A, B, C), (torch.empty_like(y), torch.empty_like(final)))
    assert y.shape == (b, s, h, p) and final.shape == (b, h, p, n) and y.dtype == torch.float32
    assert [g.shape for g in grads] == [t.shape for t in (x, dt, A, B, C)]
    dims = (b, 128, h, p, n, chunk)  # the glue pads the sequence to a chunk multiple
    assert rec == [work.KernelWork("ssd_intra_chunk", work.ssd_fwd_flops(*dims), work.ssd_fwd_bytes(*dims, 4)),
                   work.KernelWork("ssd_intra_chunk_bwd", work.ssd_bwd_flops(*dims), work.ssd_bwd_bytes(*dims, 4))]
    xr, sc = torch.empty((6, 100, 256), dtype=torch.bfloat16, device="meta"), torch.empty(256, device="meta")
    with work.recording() as rec:
        out = ops.rmsnorm(xr, sc)
    assert out.shape == xr.shape and out.dtype == xr.dtype
    assert rec == [work.KernelWork("rmsnorm", 0, 2 * 600 * 256 * 2 + 256 * 4)]
    with pytest.raises(ValueError, match="meta route takes meta tensors"):
        meta.rmsnorm(torch.zeros(2, 4), torch.ones(4))
    with pytest.raises(ValueError, match="meta route takes meta tensors"):
        meta.flash_attention(*(torch.zeros(1, 8, 2, 16) for _ in range(3)))


def test_the_smoke_bounds_are_the_package_formulas():
    """The tensor-core counts take the card's SM count; the dry run's
    default is the H100 SXM's 132."""
    case = (4, 1024, 80, 64, 128, 64)
    assert work.ssd_tensor_core_flops(*case, True) == work.ssd_tensor_core_flops(*case, True, sms=132)
    assert work.ssd_bwd_tensor_core_flops(*case, False) > work.ssd_bwd_tensor_core_flops(*case, True)
    assert work.ssd_bwd_flops(*case) > work.ssd_fwd_flops(*case)


def _sweep(tmp_path, shape):
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--sweep", "--arch", "qwen3-1.7b", "--shape", shape,
           "--out", str(tmp_path)]
    r = subprocess.run(cmd, env=ENV, capture_output=True, text=True, timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stderr
    return json.loads((tmp_path / f"qwen3-1.7b_{shape}_pod16x16.json").read_text())


JAX_KEYS = {"arch", "shape", "mesh", "status", "chips", "params_total", "params_active", "total_s",
            "memory_analysis", "opts", "hlo_flops", "hlo_bytes", "collective_bytes", "per_collective",
            "model_flops", "compute_s", "memory_s", "collective_s", "bottleneck", "useful_flops_ratio",
            "roofline_fraction", "lower_s", "compile_s", "probe_model"}


def test_one_cell_sweep_writes_the_jax_keys(tmp_path):
    res = _sweep(tmp_path, "decode_32k")
    assert JAX_KEYS <= set(res) and res["status"] == "ok" and res["cuda_initialized"] is False
    assert res["mesh"] == "pod16x16" and res["chips"] == 256
    for key in ("collective_bytes", "per_collective", "collective_s", "lower_s", "compile_s", "probe_model"):
        assert res[key] is None
    for key in ("collective_bytes", "per_collective", "lower_s", "compile_s", "probe_model", "temp_size_in_bytes"):
        assert res["not_counted"][key]
    assert res["memory_analysis"]["temp_size_in_bytes"] is None
    assert res["bottleneck"] in ("compute", "memory")
    cfg = get_config("qwen3-1.7b")
    assert res["params_total"] == M.analytic_param_count(cfg)
    assert res["model_flops"] == 2.0 * res["params_active"] * 128
    assert res["memory_s"] == pytest.approx(res["hlo_bytes"] / (256 * 3.35e12))
    assert res["memory_analysis"]["argument_size_in_bytes"] > 0 and res["hlo_flops"] > res["model_flops"] * 0.5
    skipped = _sweep(tmp_path, "long_500k")
    assert skipped["status"] == "skipped" and "full-attention" in skipped["reason"]
