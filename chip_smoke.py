#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and exits
non-zero without one. Phases, each printing one line or more:

1. card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: every kernel of the port from ``src/repro_torch/kernels/csrc``;
3. kernel against its plain version on the card, over the JAX kernel
   tests' shapes, a ragged windowed case and the serving shape;
4. small-input agreement: reduced qwen3-1.7b served on the card (kernel)
   and on the CPU (plain path) from the same weights;
5. full-width serve: ``serve_once`` on qwen3-1.7b (28 layers, d_model
   2048), batch 8, prompt 512, 32 greedy tokens; checks that every prefill
   attention went through the kernel (launch count), that the tokens are
   valid and repeatable, and holds the kernel against the plain version on
   the real q/k/v of the first and last layer; then a ``torch.profiler``
   window over one prefill and 4 decode steps: device time by kernel class
   and the device's busy share;
6. times at the serving shape (CUDA events, median of 30): kernel, plain
   version, ``scaled_dot_product_attention`` as a yardstick, and the
   card's bound;
7. the reshard row kernels (pack_rows, scatter_rows, relayout_rows,
   unpack_rows) against their plain versions, byte for byte, on the CPU
   tests' cases in f32/bf16/int8 and at the elastic path's shapes, and the
   refusal of starts that leave the array;
8. elastic serving at full width: qwen3-1.7b, 8 requests of 512-token
   prompts and 32 greedy tokens on dp2tp2, resized mid-generation to
   dp1tp2, dp1tp4 and dp2tp2; params and the live KV cache move through
   the planner, the reshard engine and the row kernels. Checks the launches
   of each commit, every migrated tensor against its source, the staging
   bound, and the tokens against an uninterrupted run; prints each
   commit's pause, plan time, bytes, data-plane rate and peak memory;
9. the data plane of the two byte-moving resizes replayed alone: wall
   time, and under ``torch.profiler`` the device time by kernel class;
10. the row kernels' times (median of 20 calls, CUDA events; and the kernel
   alone on the device, from the profiler) at the elastic path's per-layer
   move and at 4096 scattered embedding rows, beside their plain versions,
   one PyTorch call each and the HBM bound;
11. the flash-attention backward kernel against autograd of the plain
   version, over the forward's cases and the training shape, f32 and bf16;
12. the compressed wire's kernels (pack_quant_rows, dequant_scatter_rows)
   against their plain versions, byte for byte, int8 and fp8-e4m3, from
   f32 and bf16: random tiles, the edge tiles (zero, denormal, 3.38e38),
   repeated and overlapping starts, idempotence, and the training path's
   shapes;
13. live-resized training at full width: qwen3-1.7b (28 layers, d_model
   2048, fp32 params, bf16 compute, AdamW, remat per layer), global batch 4
   x 1024 tokens, on dp2tp2; a streamed resize to dp2tp4 with the Adam
   moments on the int8 wire while training continues, then a lossless
   stop-copy resize to dp1tp4. Counts every kernel launch of the run,
   checks the losses, that each commit delivered the moments' plain round
   trip (int8 commit) or the exact bytes (lossless commit), and holds the
   params after the lossless commit against a control run that was never
   resized (with the same int8 round trip applied to its moments at the
   same step); prints each commit's pause, prepare and bytes, peak memory,
   and the device's busy share over one step under ``torch.profiler``;
14. the new kernels' times (CUDA events, median of 20): the backward beside
   ``scaled_dot_product_attention``'s backward and the plain version's, the
   two quant kernels beside their plain versions, each with its bound.
The second-to-last line is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``.

Any failure raises; nothing is caught.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ParallelConfig  # noqa: E402
from repro_torch.core.events import ResizeEvent  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ref as R  # noqa: E402
from repro_torch.kernels import reshard_pack as rp  # noqa: E402
from repro_torch.kernels import reshard_quant as rq  # noqa: E402
from repro_torch.kernels.ref import flash_attention_ref  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serve import controller as serve_controller  # noqa: E402
from repro_torch.serve.controller import LiveServeController  # noqa: E402
from repro_torch.serve.driver import demo_batch, serve_once  # noqa: E402
from repro_torch.serve.loop import ServeSession  # noqa: E402

# H100 SXM data sheet: HBM3 bandwidth and dense bf16 tensor-core peak
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# (b, s, t, h, kh, d, causal, window): the shapes of the JAX package's
# test_flash_attention_sweep and its t > s case, ragged cases
FLASH_CASES = [
    (1, 128, 128, 2, 2, 64, True, 0),
    (2, 256, 256, 4, 2, 64, True, 0),
    (2, 256, 256, 4, 1, 32, True, 128),
    (1, 128, 128, 2, 2, 128, False, 0),
    (1, 384, 384, 6, 3, 64, True, 0),
    (1, 128, 256, 2, 2, 64, True, 0),
    (2, 200, 200, 4, 2, 64, True, 64),
    (2, 70, 150, 4, 2, 64, False, 0),
    (1, 150, 70, 4, 2, 64, False, 32),
    (1, 96, 96, 4, 2, 16, True, 0),  # the smallest and largest head dims built
    (1, 96, 96, 4, 2, 256, True, 0),
]
SERVE = dict(batch=8, prompt_len=512, gen=32)
SLICE_SHAPE = (8, 512, 512, 16, 8, 128, True, 0)  # the serve phase's prefill attention


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def rand_qkv(case, dtype, seed):
    b, s, t, h, kh, d, _, _ = case
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda *shape: torch.randn(shape, generator=g, device="cuda").to(dtype)  # noqa: E731
    return mk(b, s, h, d), mk(b, t, kh, d), mk(b, t, kh, d)


def kernel_vs_plain(q, k, v, **kw) -> float:
    out = fa.flash_attention_cuda(q, k, v, **kw)
    want = flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert out.dtype == q.dtype and out.shape == q.shape
    assert torch.isfinite(out.float()).all(), "kernel output not finite"
    return (out.float() - want.float()).abs().max().item()


def attended_pairs(s: int, t: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask lets through for these sizes."""
    qpos = torch.arange(s)[:, None] + (t - s)
    kpos = torch.arange(t)[None, :]
    mask = kpos <= qpos if causal else torch.ones(s, t, dtype=torch.bool)
    if window > 0:
        mask &= kpos > qpos - window
    return int(mask.sum())


def median_ms(fn, reps: int = 30, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log("card", f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}; "
                f"CUDA {torch.version.cuda}; {torch.cuda.device_count()} device(s)")
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    libs = build.build_all()
    log("build", f"{len(libs)} kernel librar{'y' if len(libs) == 1 else 'ies'} in "
                 f"{time.perf_counter() - t0:.1f}s: {sorted(libs)}")
    for name in libs:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log("build", f"{name}: {line.strip()}")


def phase_kernel_cases() -> None:
    for dtype in (torch.float32, torch.bfloat16):
        for i, case in enumerate(FLASH_CASES + ([SLICE_SHAPE] if dtype == torch.bfloat16 else [])):
            q, k, v = rand_qkv(case, dtype, seed=i)
            err = kernel_vs_plain(q, k, v, causal=case[6], window=case[7])
            log("kernel", f"flash_attention {case} {str(dtype)[6:]}: max_abs_err {err:.3e} "
                          f"(tol {TOL[dtype]:g})")
            assert err <= TOL[dtype], f"kernel disagrees with plain version on {case}: {err}"
    # what the kernel does not compute is refused, not run
    q, k, v = rand_qkv((1, 64, 64, 2, 2, 64, True, 0), torch.float32, seed=0)
    for bad, why in [((q.half(), k.half(), v.half()), "float16"),
                     ((q[..., :48].contiguous(),) * 3, "head dim 48"),
                     ((q, k[:, :32].contiguous(), v[:, :32].contiguous()), "causal t < s")]:
        try:
            fa.flash_attention_cuda(*bad)
        except ValueError:
            log("kernel", f"refused {why}")
        else:
            raise AssertionError(f"kernel accepted {why}")


def phase_small_agreement() -> None:
    """Reduced qwen3 in f32, the same weights on the card and on the CPU:
    the card's path (kernel) against the CPU's (plain version)."""
    cfg = get_config("qwen3-1.7b").reduced()
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    gpu = _to(params, "cuda")
    tokens = torch.randint(0, cfg.vocab_size, (2, 96), generator=torch.Generator().manual_seed(1))
    worst, same = 0.0, True
    with torch.inference_mode():
        lc, cc, _ = M.prefill(cfg, params, {"tokens": tokens}, torch.float32, 100)
        lg, cg, _ = M.prefill(cfg, gpu, {"tokens": tokens.cuda()}, torch.float32, 100)
        for i in range(4):
            worst = max(worst, (lg.cpu() - lc).abs().max().item())
            tc, tg = lc[:, -1].argmax(-1, keepdim=True), lg[:, -1].argmax(-1, keepdim=True)
            same &= torch.equal(tc, tg.cpu())
            lc, cc = M.decode_step(cfg, params, cc, tc, 96 + i)
            lg, cg = M.decode_step(cfg, gpu, cg, tg, 96 + i)
    log("agree", f"reduced qwen3 f32 card vs CPU: max logit diff {worst:.3e}, greedy tokens equal {same}")
    assert worst <= 1e-3 and same, "card and CPU paths disagree"


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device) for k, v in tree.items()}


def phase_serve() -> tuple[int, float]:
    cfg = get_config("qwen3-1.7b")
    torch.cuda.reset_peak_memory_stats()
    fa.launches = 0  # the main path's count starts here
    out = serve_once(cfg, device="cuda", seed=0, **SERVE)
    launches = fa.launches  # ... and is read here
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    toks = out["tokens"]
    tok_s = SERVE["batch"] * SERVE["gen"] / out["decode_s"]
    log("serve", f"{cfg.name} full width ({cfg.num_layers} layers, d_model {cfg.d_model}), batch "
                 f"{SERVE['batch']} x prompt {SERVE['prompt_len']}, {SERVE['gen']} greedy tokens: "
                 f"prefill_s {out['prefill_s']:.4f}, decode_s {out['decode_s']:.4f} "
                 f"({tok_s:.1f} tok/s), peak memory {peak_gb:.2f} GB, flash launches {launches}")
    assert launches == cfg.num_layers, f"{launches} flash launches, want {cfg.num_layers}"
    assert toks.shape == (SERVE["batch"], SERVE["gen"] + 1), toks.shape
    assert toks.min() >= 0 and toks.max() < cfg.vocab_size

    # second run: same tokens; capture q/k/v of the first and last layer
    captured, calls, orig = {}, [0], ops.flash_attention

    def capture(q, k, v, **kw):
        i = calls[0]
        calls[0] += 1
        if i in (0, cfg.num_layers - 1):
            captured[i] = (q.clone(), k.clone(), v.clone(), kw)
        return orig(q, k, v, **kw)

    ops.flash_attention = capture
    try:
        again = serve_once(cfg, device="cuda", seed=0, **SERVE)
    finally:
        ops.flash_attention = orig
    assert (again["tokens"] == toks).all(), "a second run gave other tokens"
    worst = 0.0
    for i, (q, k, v, kw) in sorted(captured.items()):
        err = kernel_vs_plain(q, k, v, **kw)
        log("serve", f"layer {i} prefill attention {tuple(q.shape)} {str(q.dtype)[6:]}: kernel vs "
                     f"plain max_abs_err {err:.3e}")
        assert err <= TOL[q.dtype]
        worst = max(worst, err)

    # the logits themselves: finite, of the expected shape
    params = M.cast_params(
        M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda"), cfg.dtype
    )
    with torch.inference_mode():
        logits, cache, _ = M.prefill(cfg, params, demo_batch(cfg, SERVE["batch"], SERVE["prompt_len"]),
                                     max_seq=SERVE["prompt_len"] + 4)
    assert logits.shape == (SERVE["batch"], 1, cfg.vocab_size)
    assert torch.isfinite(logits.float()).all(), "full-width logits not finite"
    assert (logits[:, -1].argmax(-1).cpu().numpy() == toks[:, 0]).all()
    log("serve", f"full-width prefill logits {tuple(logits.shape)} finite; first tokens match; "
                 f"second run identical")
    phase_profile(cfg, params, logits, cache)
    del params, logits, cache
    torch.cuda.empty_cache()
    return launches, worst


def _kernel_class(name: str) -> str:
    if "fa_fwd_kernel" in name:
        return "flash"
    if any(tag in name.lower() for tag in ("gemm", "gemv", "xmma", "cutlass", "cublas", "nvjet")):
        return "matmul"
    return "other"


def phase_profile(cfg, params, logits, cache) -> None:
    """Where the serve path's time goes: ``torch.profiler`` over one
    full-width prefill and 4 decode steps, device time by kernel class
    against the window's wall time (the profiler's own host cost inflates
    the wall time, so the busy share is a lower bound)."""
    from torch.profiler import ProfilerActivity, profile

    batch = demo_batch(cfg, SERVE["batch"], SERVE["prompt_len"])
    cur = logits[:, -1].argmax(-1, keepdim=True)
    runs = {
        "prefill": lambda: M.prefill(cfg, params, batch, max_seq=SERVE["prompt_len"] + 4),
        "decode x4": lambda: [M.decode_step(cfg, params, cache, cur, SERVE["prompt_len"] + i)
                              for i in range(4)],
    }
    for name, fn in runs.items():
        with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        busy = {"flash": 0.0, "matmul": 0.0, "other": 0.0}
        by_name: dict[str, float] = {}
        count = 0
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                ms = e.time_range.elapsed_us() / 1e3
                busy[_kernel_class(e.name)] += ms
                by_name[e.name] = by_name.get(e.name, 0.0) + ms
                count += 1
        if count == 0:
            log("profile", f"{name}: device time not measured (the profiler saw no kernels)")
            continue
        total = sum(busy.values())
        log("profile", f"{name}: wall {wall_ms:.3f} ms under the profiler, {count} kernels, device busy "
                       f"{total:.3f} ms ({100 * total / wall_ms:.1f}%): matmul {busy['matmul']:.3f} ms, "
                       f"flash {busy['flash']:.3f} ms, other {busy['other']:.3f} ms")
        for kname, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
            log("profile", f"  {name}: {ms:8.3f} ms  {kname[:110]}")


def phase_times(launches: int, serve_err: float) -> dict:
    b, s, t, h, kh, d, causal, window = SLICE_SHAPE
    q, k, v = rand_qkv(SLICE_SHAPE, torch.bfloat16, seed=99)
    kw = dict(causal=causal, window=window)
    err = kernel_vs_plain(q, k, v, **kw)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    kernel_ms = median_ms(lambda: fa.flash_attention_cuda(q, k, v, **kw))
    plain_ms = median_ms(lambda: flash_attention_ref(q, k, v, **kw))
    library_ms = median_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=True))
    nbytes = sum(x.numel() * x.element_size() for x in (q, k, v, q))  # q, k, v in; o out
    flops = 4 * d * b * h * attended_pairs(s, t, causal, window)  # QK^T and PV
    bytes_ms, flops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOP_PER_S * 1e3
    bound_ms = max(bytes_ms, flops_ms)
    log("times", f"flash_attention {SLICE_SHAPE} bf16: kernel {kernel_ms:.4f} ms, plain "
                 f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
                 f"({nbytes / 1e6:.1f} MB -> {bytes_ms:.4f} ms; {flops / 1e9:.2f} GFLOP -> "
                 f"{flops_ms:.4f} ms)")
    max_err = max(err, serve_err)  # this shape and the serve phase's real layers
    # the record carries both the smoke contract's key names (ms,
    # max_abs_err) and the issue's (kernel_ms, max_err)
    return {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:124",
        "launches": launches,
        "max_abs_err": max_err,
        "max_err": max_err,
        "ms": kernel_ms,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
        "library_ms": library_ms,
    }

# ---------------------------------------------------------------------------
# Reshard row kernels and the elastic serving path
# ---------------------------------------------------------------------------

ROW_KERNELS = ("pack_rows", "scatter_rows", "relayout_rows", "unpack_rows")
# the file:line of each TPU kernel's pallas_call
ROW_REPLACES = {
    "pack_rows": "src/repro/kernels/reshard_pack.py:60",
    "unpack_rows": "src/repro/kernels/reshard_pack.py:95",
    "relayout_rows": "src/repro/kernels/reshard_pack.py:134",
    "scatter_rows": "src/repro/kernels/reshard_pack.py:180",
}
ROW_DTYPES = (torch.float32, torch.bfloat16, torch.int8)
EMBED = (151936, 2048)  # qwen3-1.7b's embedding table
CACHE_ROW = (28, 8 * 544 * 8 * 128)  # a stacked cache leaf, 8 slots x 544 positions, flattened
OVERLAP_STARTS = [[3, 17, 5, 5, 29], [30, 1, 12, 9, 2]]  # unaligned, overlapping, repeated
ELASTIC = dict(n_slots=8, prompt_len=512, max_seq=544, gen=32)
ELASTIC_TRACE = [(8.0, (1, 2)), (16.0, (1, 4)), (24.0, (2, 2))]  # (time, (dp, tp)); starts on dp2tp2


def rand_rows(shape, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    if dtype == torch.int8:
        return torch.randint(-128, 128, shape, generator=g, device="cuda", dtype=torch.int8)
    return torch.randn(shape, generator=g, device="cuda").to(dtype)


def row_kernel_vs_plain(kind, rows, C, dtype, starts, block_rows, seed) -> None:
    """One row kernel against its plain version on the same inputs: the
    outputs must be equal byte for byte."""
    nb = len(starts)
    src, dst = rand_rows((rows, C), dtype, seed), rand_rows((rows, C), dtype, seed + 1)
    buf = rand_rows((nb * block_rows, C), dtype, seed + 2)
    if kind == "pack_rows":
        got, want = rp.pack_rows_cuda(src, starts, block_rows), R.pack_rows_ref(src, starts, block_rows)
    elif kind == "scatter_rows":
        got = rp.scatter_rows_cuda(dst.clone(), buf, starts, block_rows)
        want = R.scatter_rows_ref(dst.clone(), buf, starts, block_rows)
    elif kind == "relayout_rows":
        got = rp.relayout_rows_cuda(dst.clone(), src, starts, block_rows)
        want = R.relayout_rows_ref(dst.clone(), src, starts, block_rows)
    else:
        got, want = rp.unpack_rows_cuda(buf, starts, block_rows, rows), R.unpack_rows_ref(buf, starts, block_rows, rows)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.equal(got, want), (
        f"{kind} disagrees with its plain version: rows {rows}, C {C}, {dtype}, starts {list(starts)[:8]}, "
        f"block_rows {block_rows}")


def phase_row_cases() -> None:
    """The four row kernels against their plain versions, exact equality:
    the CPU tests' sweeps and unaligned/overlapping cases in three dtypes,
    then the elastic path's shapes, scattered, repeated and overlapping
    starts at the embedding's size, and the refusal of bad starts."""
    rng = np.random.default_rng(0)
    n = 0
    for dtype in ROW_DTYPES:
        for seed in range(5):
            for kind in ROW_KERNELS:
                nb = int(rng.integers(1, 7))
                block = int(rng.choice([8, 16] if kind in ("pack_rows", "unpack_rows") else [1, 8]))
                R_ = block * int(rng.integers(max(nb, 2), 13))
                starts = [int(x) for x in rng.choice(R_ // block, size=nb, replace=False) * block]
                row_kernel_vs_plain(kind, R_, 128, dtype, starts, block, seed)
                n += 1
        for kind in ROW_KERNELS:
            row_kernel_vs_plain(kind, 16, 128, dtype, [4, 4, 9], 1, 7)
            n += 1
            for C in (1, 3, 130):
                for starts in OVERLAP_STARTS:
                    row_kernel_vs_plain(kind, 40, C, dtype, starts, 8, C)
                    n += 1
        log("rows", f"{str(dtype)[6:]}: {n} cases equal (JAX sweeps with C=128; repeated starts; "
                    "unaligned and overlapping starts, block 8, C in 1/3/130)")
        n = 0
    scattered = [int(x) for x in rng.permutation(EMBED[0])[:4096]]
    repeated = [int(x) for x in rng.integers(0, EMBED[0], 4096)] + scattered[:64]
    overlapping = sorted(int(x) for x in rng.integers(0, EMBED[0] - 16, 512))
    overlapping += [s + 3 for s in overlapping[:64]]
    for kind in ROW_KERNELS:
        row_kernel_vs_plain(kind, *CACHE_ROW, torch.bfloat16, [5], 1, 11)
        row_kernel_vs_plain(kind, *EMBED, torch.bfloat16, scattered, 1, 12)
        row_kernel_vs_plain(kind, *EMBED, torch.bfloat16, repeated, 1, 13)
        row_kernel_vs_plain(kind, *EMBED, torch.bfloat16, overlapping, 8, 14)
        # one run of half the table, as the elastic path's embedding moves
        row_kernel_vs_plain(kind, *EMBED, torch.bfloat16, [EMBED[0] // 4], EMBED[0] // 2, 15)
        log("rows", f"{kind}: equal on a cache row {CACHE_ROW} bf16, 4096 scattered embedding rows "
                    f"{EMBED} bf16, 4160 starts with repeats, 576 overlapping blocks of 8, one run of "
                    f"{EMBED[0] // 2} rows")
    src = rand_rows((64, 8), torch.float32, 0)
    bad = {
        "pack_rows start 64": lambda: rp.pack_rows_cuda(src, [64], 1),
        "scatter_rows start -1": lambda: rp.scatter_rows_cuda(src, src[:1], [-1], 1),
        "relayout_rows block past the end": lambda: rp.relayout_rows_cuda(src, src.clone(), [63], 2),
        "unpack_rows start 64": lambda: rp.unpack_rows_cuda(src[:1], [64], 1, 64),
    }
    for why, call in bad.items():
        try:
            call()
        except ValueError:
            log("rows", f"refused {why}")
        else:
            raise AssertionError(f"row kernel accepted {why}")


def elastic_session(cfg, prompts, trace):
    ctrl = LiveServeController(cfg, ParallelConfig(dp=2, tp=2), ELASTIC["n_slots"], ELASTIC["prompt_len"],
                               ELASTIC["max_seq"], cache_dtype=torch.bfloat16, device="cuda", sync_prepare=True)
    sess = ServeSession(ctrl, step_time_s=1.0)
    for p in prompts:
        sess.submit(p, ELASTIC["gen"])
    events = [ResizeEvent(time_s=t, target=ParallelConfig(dp=dp, tp=tp)) for t, (dp, tp) in trace]
    results, metrics = sess.run(events)
    records = list(ctrl.records)
    ctrl.shutdown()
    return results, metrics, records


def phase_elastic() -> dict:
    """qwen3-1.7b at full width serves 8 requests (512-token prompts, 32
    greedy tokens) on dp2tp2 and resizes three times mid-generation; params
    and the live KV cache move through the planner, the engine and the row
    kernels. A wrapper around ``live_reshard_planned`` counts each commit's
    launches, checks every migrated tensor against its source byte for byte
    and the staging bound. Tokens must equal an uninterrupted run."""
    cfg = get_config("qwen3-1.7b")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, ELASTIC["prompt_len"]) for _ in range(ELASTIC["n_slots"])]
    commits: list[dict] = []
    orig_reshard, orig_relayout = serve_controller.live_reshard_planned, ops.relayout_rows
    relayout_ptrs: set[int] = set()

    def relayout_recorded(dst, src, starts, block_rows):
        relayout_ptrs.add(dst.data_ptr())
        return orig_relayout(dst, src, starts, block_rows)

    def checked(specs, plan, named, *args, **kwargs):
        relayout_ptrs.clear()
        before = dict(rp.launches)
        torch.cuda.reset_peak_memory_stats()
        dst, stats = orig_reshard(specs, plan, named, *args, **kwargs)
        peak = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        assert set(dst) == set(named), "a tensor was not migrated"
        unequal = [n for n in named if not torch.equal(dst[n], named[n])]
        assert not unequal, f"migrated tensors differ from their sources: {unequal[:4]}"
        stats.assert_bounded(kwargs["staging_bytes"])
        commits.append({
            "launched": {k: rp.launches[k] - before[k] for k in before},
            "relayout": sorted(n for n, t in dst.items() if t.data_ptr() in relayout_ptrs),
            "check_s": time.perf_counter() - t0, "stats": stats, "peak_gb": peak / 1e9,
        })
        return dst, stats

    serve_controller.live_reshard_planned, ops.relayout_rows = checked, relayout_recorded
    try:
        fa.launches = 0  # the elastic path's counts start here ...
        for k in rp.launches:
            rp.launches[k] = 0
        results, metrics, records = elastic_session(cfg, prompts, ELASTIC_TRACE)
        launches = {"flash_attention": fa.launches, **rp.launches}  # ... and are read here
    finally:
        serve_controller.live_reshard_planned, ops.relayout_rows = orig_reshard, orig_relayout
    plain, _, _ = elastic_session(cfg, prompts, [])
    log("elastic", f"{cfg.name} full width, {ELASTIC['n_slots']} requests x prompt {ELASTIC['prompt_len']}, "
                   f"{ELASTIC['gen']} greedy tokens, dp2tp2 -> " + " -> ".join(f"dp{d}tp{t}" for _, (d, t) in ELASTIC_TRACE)
                   + f": {metrics.commits} commits, {metrics.tokens_emitted} tokens, dropped {metrics.dropped}, "
                     f"wall {metrics.wall_s:.3f}s; main-path launches {launches}")
    assert metrics.commits == 3 and len(records) == 3 == len(commits), (metrics.commits, len(records))
    for i, (rec, c) in enumerate(zip(records, commits)):
        pause_s = rec.pause_s - c["check_s"]  # the smoke's own equality check is not the system's pause
        plane_s = pause_s - rec.plan_s
        log("elastic", f"commit {i + 1} {rec.src} -> {rec.dst}: cut_step {rec.cut_step}, pause_s {pause_s:.4f}, "
                       f"plan_s {rec.plan_s:.4f}, executed {rec.executed_bytes / 1e9:.4f} GB, data plane "
                       f"{rec.executed_bytes / 1e9 / plane_s:.1f} GB/s over {plane_s:.4f}s, peak memory "
                       f"{c['peak_gb']:.2f} GB, launches {c['launched']}, relayout on {c['relayout']}, "
                       f"cache-resident layers {rec.cache_resident_layers}, resident tensors adopted "
                       f"{rec.skipped_bytes / 1e9:.4f} GB")
        assert rec.cut_step > 0, rec.cut_step
    first, second, third = commits
    assert not any(first["launched"].values()) and records[0].executed_bytes == 0, first["launched"]
    assert second["launched"]["relayout_rows"] == 0 and not second["relayout"]
    assert third["relayout"] == ["params/embed/tok", "params/final_norm/scale"], third["relayout"]
    for c in (second, third):
        assert c["launched"]["pack_rows"] == c["launched"]["scatter_rows"] > 0, c["launched"]
        assert c["launched"]["unpack_rows"] == 0
    assert launches["flash_attention"] == cfg.num_layers, launches  # one wave, one prefill
    assert all(launches[k] == sum(c["launched"][k] for c in commits) for k in ROW_KERNELS)
    assert results == plain, "the resized run's tokens differ from the uninterrupted run's"
    assert all(0 <= t < cfg.vocab_size for toks in results.values() for t in toks)
    assert all(len(toks) == ELASTIC["gen"] for toks in results.values()) and len(results) == ELASTIC["n_slots"]
    log("elastic", "tokens equal the uninterrupted dp2tp2 run; every migrated tensor equals its source")
    return launches


def device_ms(fn, kernel: str, calls: int = 10, per_call: bool = False) -> float:
    """Median device time of ``kernel`` (a substring of its name) over
    ``calls`` calls of ``fn``, from ``torch.profiler``: the kernel alone,
    without the host work around its launch. ``per_call``: the summed time
    of every matching kernel over the number of calls (a call that
    launches two kernels)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name]
    assert times, f"the profiler saw no {kernel}"
    return sum(times) / calls if per_call else statistics.median(times)


def _device_class(name: str) -> str:
    for kind in ROW_KERNELS:
        if f"{kind}_kernel" in name:
            return kind
    if "Memcpy" in name:
        return "memcpy"
    if "fill" in name.lower() or "Memset" in name:
        return "zero-fill"
    return "other"


def phase_commit_profile() -> None:
    """Where a commit's data-plane time goes: the elastic path's two
    byte-moving resizes (dp1tp2 -> dp1tp4, dp1tp4 -> dp2tp2) replayed on a
    full-width serving state (random bytes) through ``live_reshard_planned``,
    three timed runs each, then one under ``torch.profiler``: device time by
    class against the wall time, and the host time per launch."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.reshard import live_reshard_planned
    from repro_torch.serve.cache_view import serve_plan, serve_state_specs

    cfg = get_config("qwen3-1.7b")
    specs = serve_state_specs(cfg, ELASTIC["n_slots"], ELASTIC["max_seq"], torch.bfloat16)
    state = {s.name: rand_rows(s.shape, getattr(torch, s.dtype), i) for i, s in enumerate(specs)}
    dev = torch.device("cuda", torch.cuda.current_device())
    for a, b in [((1, 2), (1, 4)), ((1, 4), (2, 2))]:
        ca, cb = ParallelConfig(dp=a[0], tp=a[1]), ParallelConfig(dp=b[0], tp=b[1])
        plan = serve_plan(cfg, specs, ca, cb)
        worlds = ([dev] * ca.world_size, [dev] * cb.world_size)
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dst, stats = live_reshard_planned(specs, plan, state, *worlds)
            walls.append(time.perf_counter() - t0)
            del dst
        before = dict(rp.launches)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            dst, stats = live_reshard_planned(specs, plan, state, *worlds)
            wall_ms = (time.perf_counter() - t0) * 1e3
        launched = sum(rp.launches[k] - before[k] for k in before)
        assert all(torch.equal(dst[n], state[n]) for n in dst)
        del dst
        busy: dict[str, float] = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                cls = _device_class(e.name)
                busy[cls] = busy.get(cls, 0.0) + e.time_range.elapsed_us() / 1e3
        total = sum(busy.values())
        log("commit", f"{ca.describe()} -> {cb.describe()} data plane (no planner), "
                      f"{stats.executed_bytes / 1e9:.4f} GB: wall {statistics.median(walls) * 1e3:.3f} ms "
                      f"(median of 3; {', '.join(f'{w * 1e3:.3f}' for w in walls)}); under the profiler "
                      f"{wall_ms:.3f} ms wall, device busy {total:.3f} ms ({100 * total / wall_ms:.1f}%): "
                      + ", ".join(f"{k} {v:.3f} ms" for k, v in sorted(busy.items(), key=lambda kv: -kv[1]))
                      + f"; {launched} row launches, host {(wall_ms - total) / max(launched, 1):.3f} ms per launch "
                        "beyond the device time")
    del state
    torch.cuda.empty_cache()


def _row_bytes_moved(kind, C, nb, block_rows, out_rows, itemsize) -> int:
    """Bytes the copy must move: each input read once, each output written
    once (the offset table included)."""
    moved = nb * block_rows * C * itemsize
    if kind == "unpack_rows":
        return moved + out_rows * C * itemsize + nb * 8
    return 2 * moved + nb * 8


def phase_row_times(launches: dict) -> list[dict]:
    """Each row kernel at the elastic path's per-layer move (one row of the
    stacked cache leaf, bf16) and at 4096 scattered embedding rows: kernel,
    plain version, one PyTorch call as a yardstick, and the HBM bound. The
    source rows rotate between calls so that the inputs are not left in the
    50 MB L2 cache."""
    out = []
    cases = {
        "cache_row": (CACHE_ROW, [[i] for i in range(CACHE_ROW[0])]),
        "embed_4096": (EMBED, [[int(x) for x in np.random.default_rng(s).permutation(EMBED[0])[:4096]]
                               for s in range(8)]),
    }
    for kind in ROW_KERNELS:
        rec = None
        for case, (shape, start_sets) in cases.items():
            rows, C = shape
            src, dst = rand_rows(shape, torch.bfloat16, 21), rand_rows(shape, torch.bfloat16, 22)
            nb = len(start_sets[0])
            buf = rand_rows((nb, C), torch.bfloat16, 23)
            idx = [torch.tensor(s, device="cuda") for s in start_sets]
            turn = [0]

            def nxt():
                turn[0] += 1
                return turn[0] % len(start_sets)

            kernel = {
                "pack_rows": lambda: rp.pack_rows_cuda(src, start_sets[nxt()], 1),
                "scatter_rows": lambda: rp.scatter_rows_cuda(dst, buf, start_sets[nxt()], 1),
                "relayout_rows": lambda: rp.relayout_rows_cuda(dst, src, start_sets[nxt()], 1),
                "unpack_rows": lambda: rp.unpack_rows_cuda(buf, start_sets[nxt()], 1, rows),
            }[kind]
            plain = {
                "pack_rows": lambda: R.pack_rows_ref(src, start_sets[nxt()], 1),
                "scatter_rows": lambda: R.scatter_rows_ref(dst, buf, start_sets[nxt()], 1),
                "relayout_rows": lambda: R.relayout_rows_ref(dst, src, start_sets[nxt()], 1),
                "unpack_rows": lambda: R.unpack_rows_ref(buf, start_sets[nxt()], 1, rows),
            }[kind]

            def library():
                i = idx[nxt()]
                if kind == "pack_rows":
                    return torch.index_select(src, 0, i)
                if kind == "scatter_rows":
                    return dst.index_copy_(0, i, buf)
                if kind == "relayout_rows":
                    dst[i] = src[i]
                    return dst
                return torch.zeros((rows, C), dtype=buf.dtype, device="cuda").index_copy_(0, i, buf)

            a = {"pack_rows": lambda s: rp.pack_rows_cuda(src, s, 1),
                 "scatter_rows": lambda s: rp.scatter_rows_cuda(dst.clone(), buf, s, 1),
                 "relayout_rows": lambda s: rp.relayout_rows_cuda(dst.clone(), src, s, 1),
                 "unpack_rows": lambda s: rp.unpack_rows_cuda(buf, s, 1, rows)}[kind](start_sets[0])
            b = {"pack_rows": lambda s: R.pack_rows_ref(src, s, 1),
                 "scatter_rows": lambda s: R.scatter_rows_ref(dst.clone(), buf, s, 1),
                 "relayout_rows": lambda s: R.relayout_rows_ref(dst.clone(), src, s, 1),
                 "unpack_rows": lambda s: R.unpack_rows_ref(buf, s, 1, rows)}[kind](start_sets[0])
            err = (a.float() - b.float()).abs().max().item()
            del a, b
            kernel_ms = median_ms(kernel, reps=20)
            plain_ms = median_ms(plain, reps=20)
            library_ms = median_ms(library, reps=20)
            on_device_ms = device_ms(kernel, f"{kind}_kernel")
            nbytes = _row_bytes_moved(kind, C, nb, 1, rows, 2)
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
            log("times", f"{kind} {case} ({nb} of {rows} rows x {C} bf16): call {kernel_ms:.4f} ms (kernel "
                         f"on the device {on_device_ms:.4f} ms, {nbytes / on_device_ms / 1e6:.0f} GB/s), plain "
                         f"{plain_ms:.4f} ms, library {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
                         f"({nbytes / 1e6:.1f} MB), max_abs_err {err:g}")
            assert err == 0.0, f"{kind} disagrees with its plain version at {case}"
            if case == "cache_row":  # the elastic path's per-layer move goes in the record
                rec = {
                    "name": kind,
                    "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/reshard_pack.cu",
                    "replaces": ROW_REPLACES[kind],
                    "launches": launches[kind],
                    "max_abs_err": err,
                    "max_err": err,
                    "ms": kernel_ms,
                    "kernel_ms": kernel_ms,
                    "device_ms": on_device_ms,
                    "plain_ms": plain_ms,
                    "bound_ms": bound_ms,
                    "bound_by": "bytes",
                    "library_ms": library_ms,
                    "shape": f"{nb} of {rows} rows x {C} bf16",
                }
            del src, dst, buf, idx
            torch.cuda.empty_cache()
        out.append(rec)
    return out


# ---------------------------------------------------------------------------
# Slice 3: the backward kernel, the compressed wire, live-resized training
# ---------------------------------------------------------------------------

# the training path's attention: batch 4 x 1024 tokens, 16 q / 8 kv heads of 128
TRAIN_SHAPE = (4, 1024, 1024, 16, 8, 128, True, 0)
# relative to the largest plain-version gradient: f32 sums in another order
# over up to 1024 rows; bf16 rounds the kernel's output and dq/dk/dv once
BWD_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
TRAIN = dict(arch="qwen3-1.7b", batch=4, seq=1024, before=3, after=3, stream_k=8, device="cuda")
QUANT_FORMATS = ("int8", "fp8_e4m3")
STACKED_MOMENT = (28, 2048 * 6144)  # a stacked moment of qwen3-1.7b (mlp/wi_gate), one row a layer


def bwd_vs_plain(case, dtype, seed) -> float:
    """The backward kernel (through the autograd Function) against autograd
    of the plain version on the same inputs and output gradient: the
    largest |error| over dq, dk, dv, relative to the largest plain value."""
    q, k, v = rand_qkv(case, dtype, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1000)
    dout = torch.randn(q.shape, generator=g, device="cuda").to(dtype)
    kw = dict(causal=case[6], window=case[7])
    before = fa.bwd_launches
    qk, kk, vk = (x.clone().requires_grad_(True) for x in (q, k, v))
    got = torch.autograd.grad(fa.flash_attention(qk, kk, vk, **kw), (qk, kk, vk), dout)
    qr, kr, vr = (x.clone().requires_grad_(True) for x in (q, k, v))
    want = torch.autograd.grad(flash_attention_ref(qr, kr, vr, **kw), (qr, kr, vr), dout)
    torch.cuda.synchronize()
    assert fa.bwd_launches == before + 1, "the autograd Function did not launch the backward kernel"
    worst, scale = 0.0, 0.0
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape and torch.isfinite(a.float()).all()
        worst = max(worst, (a.float() - b.float()).abs().max().item())
        scale = max(scale, b.float().abs().max().item())
    return worst / scale


def phase_bwd_cases() -> float:
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for i, case in enumerate(FLASH_CASES + [TRAIN_SHAPE]):
            rel = bwd_vs_plain(case, dtype, seed=100 + i)
            log("bwd", f"flash_attention backward {case} {str(dtype)[6:]}: max |error| / max |plain| "
                       f"{rel:.3e} over dq, dk, dv (tol {BWD_TOL[dtype]:g})")
            assert rel <= BWD_TOL[dtype], f"backward kernel disagrees with autograd of the plain version on {case}"
            worst = max(worst, rel) if dtype == torch.bfloat16 else worst
    return worst


def _bytes(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.uint8)


def quant_vs_plain(src, starts, block_rows, fmt, dst=None) -> None:
    """Both quant kernels against their plain versions, byte for byte:
    payload, scales, the dequantized scatter into ``dst`` (repeated starts
    included) and its idempotence."""
    q, s = rq.pack_quant_rows_cuda(src, starts, block_rows, fmt)
    q_r, s_r = R.pack_quant_rows_ref(src, starts, block_rows, fmt)
    torch.cuda.synchronize()
    assert torch.equal(_bytes(q), _bytes(q_r)), f"pack_quant_rows payload differs ({fmt}, {src.dtype}, {tuple(src.shape)})"
    assert torch.equal(_bytes(s), _bytes(s_r)), f"pack_quant_rows scales differ ({fmt}, {src.dtype})"
    dst = torch.zeros_like(src) if dst is None else dst
    once = rq.dequant_scatter_rows_cuda(dst.clone(), q, s, starts, block_rows)
    want = R.dequant_scatter_rows_ref(dst.clone(), q_r, s_r, starts, block_rows)
    twice = rq.dequant_scatter_rows_cuda(once.clone(), q, s, starts, block_rows)
    torch.cuda.synchronize()
    assert torch.equal(_bytes(once), _bytes(want)), f"dequant_scatter_rows differs ({fmt}, {src.dtype})"
    assert torch.equal(_bytes(twice), _bytes(once)), "dequant_scatter_rows is not idempotent"


def phase_quant_cases() -> None:
    rng = np.random.default_rng(3)
    for fmt in QUANT_FORMATS:
        for dtype in (torch.float32, torch.bfloat16):
            n = 0
            for seed in range(6):
                rows, C = int(rng.integers(8, 64)), int(rng.choice([1, 3, 128, 130, 4096]))
                block = int(rng.choice([1, 2, 8])) if rows >= 16 else 1
                nb = int(rng.integers(1, rows // block + 1))
                starts = [int(x) for x in rng.integers(0, rows - block + 1, nb)]  # repeats, overlaps
                src = rand_rows((rows, C), dtype, seed) * float(10.0 ** rng.integers(-30, 30))
                quant_vs_plain(src, starts, block, fmt, rand_rows((rows, C), dtype, seed + 1))
                n += 1
            edge = torch.tensor([[0.0] * 128, [1e-40] * 128, [3.38e38] * 128], device="cuda").to(dtype)
            quant_vs_plain(edge, [0, 1, 2], 1, fmt, torch.ones_like(edge))
            quant_vs_plain(edge, [2, 0, 2, 1, 0], 1, fmt, torch.ones_like(edge))  # repeated: the last wins
            log("quant", f"{fmt} from {str(dtype)[6:]}: {n} random cases (C 1..4096, blocks 1/2/8, repeated and "
                         "overlapping starts) and the edge tiles (0, 1e-40, 3.38e38) equal byte for byte; "
                         "dequant_scatter idempotent")
        # the training path's shapes: a stacked moment, one tile a layer, and
        # 4096 scattered embedding-moment rows (fp32 moments)
        stacked = rand_rows(STACKED_MOMENT, torch.float32, 40) * 1e-3
        quant_vs_plain(stacked, [3, 17, 27], 1, fmt)
        del stacked
        embed = rand_rows(EMBED, torch.float32, 41) * 1e-4
        quant_vs_plain(embed, [int(x) for x in rng.permutation(EMBED[0])[:4096]], 1, fmt)
        del embed
        torch.cuda.empty_cache()
        log("quant", f"{fmt}: equal on 3 rows of a stacked moment {STACKED_MOMENT} f32 and 4096 scattered "
                     f"rows of the embedding moment {EMBED} f32")
    src = rand_rows((16, 8), torch.float32, 0)
    for why, call in {
        "pack_quant_rows start 16": lambda: rq.pack_quant_rows_cuda(src, [16], 1, "int8"),
        "pack_quant_rows int8 source": lambda: rq.pack_quant_rows_cuda(src.to(torch.int8), [0], 1, "int8"),
        "dequant_scatter_rows start -1": lambda: rq.dequant_scatter_rows_cuda(
            src, src[:1].to(torch.int8), torch.ones(1, 1, device="cuda"), [-1], 1),
    }.items():
        try:
            call()
        except ValueError:
            log("quant", f"refused {why}")
        else:
            raise AssertionError(f"quant kernel accepted {why}")


def _all_counts() -> dict:
    return {"flash_attention": fa.launches, "flash_attention_bwd": fa.bwd_launches, **rp.launches, **rq.launches}


def _zero_counts() -> None:
    fa.launches = fa.bwd_launches = 0
    for counts in (rp.launches, rq.launches):
        for k in counts:
            counts[k] = 0


def _round_trip_rows(x: torch.Tensor, fmt: str) -> torch.Tensor:
    """The plain round trip of every row of ``x`` (one tile a row), in
    slices of rows so that the temporaries stay small."""
    x2 = x.reshape(x.shape[0], -1)
    out = torch.empty_like(x2)
    per = max(1, (1 << 24) // x2.shape[1])
    for lo in range(0, x2.shape[0], per):
        out[lo : lo + per] = R.quant_round_trip_ref(x2[lo : lo + per], fmt)
    return out.reshape(x.shape)


def phase_train() -> dict:
    """Live-resized training at full width (see the module docstring, 13)."""
    from repro_torch.core import controller as C
    from repro_torch.core.controller import LiveRController
    from repro_torch.optim import AdamWConfig
    from repro_torch.reshard import WirePolicy
    from repro_torch.utils.pytree import tree_paths

    cfg = get_config(TRAIN["arch"])
    opt = AdamWConfig(learning_rate=1e-4, warmup_steps=2, total_steps=1000)
    kw = dict(seq_len=TRAIN["seq"], global_batch=TRAIN["batch"], device=TRAIN["device"], stream_k=TRAIN["stream_k"])
    commits: list[dict] = []
    orig_rebuild = C.rebuild_state

    def checked_rebuild(named, params_like, opt_like, extras):
        """At each commit, before any update: the delivered state against
        the cut it was moved from."""
        t0 = time.perf_counter()
        policy = ctrl.wire_policy
        old = {f"params/{p}": x for p, x in tree_paths(params_like).items()}
        for coll in ("mu", "nu"):
            old.update({f"{coll}/{p}": x for p, x in tree_paths(opt_like[coll]).items()})
        adopted, quantized, nu_zeroed = [], [], [0, 0]
        for name, new in named.items():
            fmt = policy.format_for(name.split("/")[0]) if policy is not None else "none"
            if new is old[name]:
                adopted.append(name)
                continue
            want = old[name] if fmt == "none" else _round_trip_rows(old[name], fmt)
            assert torch.equal(_bytes(new), _bytes(want)), f"{name}: the commit did not deliver {fmt} bytes of the cut"
            if fmt != "none":
                quantized.append(name)
                if name.startswith("nu/"):
                    nu_zeroed[0] += int(((new == 0) & (old[name] != 0)).sum())
                    nu_zeroed[1] += int((old[name] != 0).sum())
        torch.cuda.synchronize()
        commits.append({"step": ctrl.step, "adopted": adopted, "quantized": quantized, "nu_zeroed": nu_zeroed,
                        "check_s": time.perf_counter() - t0})
        return orig_rebuild(named, params_like, opt_like, extras)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    C.rebuild_state = checked_rebuild
    try:
        ctrl = LiveRController(cfg, ParallelConfig(dp=2, tp=2), opt, overlap="stream", wire_policy=WirePolicy(), **kw)
        _zero_counts()  # the training path's counts start here ...
        t_run = time.perf_counter()
        losses = ctrl.train_steps(TRAIN["before"])
        ctrl.request_resize(ParallelConfig(dp=2, tp=4))
        during = 0
        while not ctrl.records:
            losses += ctrl.train_steps(1)
            during += 1
            assert during < 200, "the streamed resize never committed"
        ctrl.wire_policy = None  # the second resize is lossless
        ctrl.request_resize(ParallelConfig(dp=1, tp=4), overlap="stop_copy")
        while len(ctrl.records) < 2:
            losses += ctrl.train_steps(1)
            during += 1
            assert during < 400, "the stop-copy resize never committed"
        snapshot = {p: x.clone() for p, x in tree_paths(ctrl.params).items()}
        at_commit = ctrl.step
        losses += ctrl.train_steps(TRAIN["after"])
        run_s = time.perf_counter() - t_run
        launches = _all_counts()  # ... and are read here
    finally:
        C.rebuild_state = orig_rebuild
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log("train", f"{cfg.name} full width ({cfg.num_layers} layers, d_model {cfg.d_model}, fp32 params, "
                 f"{cfg.dtype} compute), batch {TRAIN['batch']} x {TRAIN['seq']}, dp2tp2 -> dp2tp4 (stream, "
                 f"int8 moments) -> dp1tp4 (stop-copy, lossless): {len(losses)} steps in {run_s:.1f}s, "
                 f"losses {[round(x, 4) for x in losses]}, peak memory {peak_gb:.2f} GB, launches {launches}")
    assert all(np.isfinite(losses)), "a loss is not finite"
    assert [r.dst for r in ctrl.records] == ["dp2xpp1xtp4", "dp1xpp1xtp4"], [r.dst for r in ctrl.records]
    for i, (rec, c) in enumerate(zip(ctrl.records, commits)):
        # the smoke's own check is not the system's pause: it runs inside the
        # update phase of a split-step commit, inside the transfer of a stop-copy
        pause_s = rec.total_pause_s - c["check_s"]
        transfer_s = rec.transfer_s - (c["check_s"] if rec.mode == "live" else 0.0)
        update_s = rec.update_s - (c["check_s"] if rec.mode == "live_overlap" else 0.0)
        log("train", f"commit {i + 1} {rec.mode} {rec.src} -> {rec.dst} at step {c['step']}: pause_s {pause_s:.4f}, "
                     f"prepare_s {rec.prepare_s:.4f}, wire {rec.wire_bytes / 1e9:.4f} GB, logical "
                     f"{rec.logical_bytes / 1e9:.4f} GB, executed {rec.executed_bytes / 1e9:.4f} GB, drain_s "
                     f"{rec.drain_s:.4f}, transfer_s {transfer_s:.4f}, update_s {update_s:.4f}, "
                     f"dirty layers {rec.dirty_layers}/{rec.layers_total}, {len(c['quantized'])} tensors "
                     f"quantized, {len(c['adopted'])} adopted; nu entries the wire rounded to 0: "
                     f"{c['nu_zeroed'][0]} of {c['nu_zeroed'][1]} nonzero")
        assert rec.generic_cells == 0
    first, second = commits
    # the first commit changes tp: every moment crosses the int8 wire; the
    # second keeps tp (dp2 -> dp1), so the planner finds every cell resident
    # and the new world adopts the old one's tensors: no byte moves
    assert ctrl.records[0].executed_bytes > 0 and ctrl.records[0].wire_bytes < ctrl.records[0].logical_bytes
    assert first["quantized"] and all(n.split("/")[0] in ("mu", "nu") for n in first["quantized"])
    assert not second["quantized"] and ctrl.records[1].wire_bytes == ctrl.records[1].logical_bytes
    log("train", "every commit delivered the cut's bytes (params and the lossless commit's moments) or "
                 f"the plain int8 round trip (the first commit's moments); steps during the resizes {during}")

    # where a step's time goes: one more step on the final world, its two
    # halves (gradients, update) apart, under the profiler
    from torch.profiler import ProfilerActivity, profile

    world = ctrl.world
    batch = {"tokens": torch.from_numpy(ctrl.data.global_batch_at(ctrl.step)).to("cuda", torch.long)}
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        marks[0].record()
        _, _, grads = world.grad_fn(ctrl.params, batch)
        marks[1].record()
        world.update_fn(grads, ctrl.opt_state, ctrl.params)
        marks[2].record()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    del grads
    busy: dict[str, float] = {}
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name
            if any(k in name for k in ("bwd_dkdv", "bwd_dq", "bwd_rowdot")):
                cls = "flash backward"
            elif "fa_fwd_kernel" in name:
                cls = "flash forward"
            else:
                cls = _kernel_class(name)
            ms = e.time_range.elapsed_us() / 1e3
            busy[cls] = busy.get(cls, 0.0) + ms
            by_name[name] = by_name.get(name, 0.0) + ms
    total = sum(busy.values())
    if total == 0:
        log("train", "one step under the profiler: device time not measured (the profiler saw no kernels)")
    else:
        log("train", f"one step on dp1tp4 under the profiler: wall {wall_ms:.3f} ms (gradients "
                     f"{marks[0].elapsed_time(marks[1]):.3f} ms, AdamW update {marks[1].elapsed_time(marks[2]):.3f} "
                     f"ms on the card's clock), device busy {total:.3f} ms ({100 * total / wall_ms:.1f}%): "
                     + ", ".join(f"{k} {v:.3f} ms" for k, v in sorted(busy.items(), key=lambda kv: -kv[1])))
        for kname, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
            log("train", f"  step: {ms:8.3f} ms  {kname[:110]}")
    # iteration i ran step i + 1; the split commit ran inside the step at
    # its cut, the stop-copy commit at the boundary after the step before it
    with_commit = {first["step"], second["step"] - 1}
    plain_steps = [t for i, t in enumerate(ctrl.iteration_times) if i not in with_commit]
    log("train", f"step time on the card (host clock, steps without a commit; pre-copy rounds included): "
                 f"median {statistics.median(plain_steps):.4f} s over {len(plain_steps)} steps, "
                 f"{TRAIN['batch'] * TRAIN['seq'] / statistics.median(plain_steps):.0f} tokens/s")
    del ctrl
    torch.cuda.empty_cache()

    # the control: never resized, the same int8 round trip of its moments
    # at the first commit's cut (what the wire delivered there)
    control = LiveRController(cfg, ParallelConfig(dp=2, tp=2), opt, **kw)
    c_losses = control.train_steps(first["step"])
    with torch.no_grad():
        for coll in ("mu", "nu"):
            for p, x in tree_paths(control.opt_state[coll]).items():
                if f"{coll}/{p}" in first["quantized"]:
                    x.copy_(_round_trip_rows(x, "int8"))
    c_losses += control.train_steps(at_commit - first["step"])
    worst, equal = 0.0, True
    for p, x in tree_paths(control.params).items():
        worst = max(worst, (x - snapshot[p]).abs().max().item())
        equal &= torch.equal(x, snapshot[p])
    log("train", f"params after the lossless commit (step {at_commit}) against the control run never resized: "
                 f"max |diff| {worst:.3e} (tol 1e-2, the JAX package's RESHAPE_PARITY_TOL), bitwise equal {equal}; "
                 f"losses to there equal {c_losses == losses[:at_commit]}")
    assert worst < 1e-2, f"resized params diverge from the control run: {worst}"
    del control, snapshot
    torch.cuda.empty_cache()
    return launches, len(losses)


def check_train_launches(launches: dict, steps: int) -> None:
    """Every kernel of the training path ran on it: the forward twice a
    layer a step (remat reruns it), the backward once, the quant kernels
    in the streamed commit, the row kernels in it too."""
    layers = get_config(TRAIN["arch"]).num_layers
    for name in ("flash_attention", "flash_attention_bwd", "pack_rows", "scatter_rows",
                 "pack_quant_rows", "dequant_scatter_rows"):
        assert launches[name] > 0, f"{name} was not launched on the training path"
    assert launches["flash_attention_bwd"] == layers * steps, launches
    assert launches["flash_attention"] == 2 * layers * steps, launches
    assert launches["pack_quant_rows"] == launches["dequant_scatter_rows"]
    assert launches["pack_rows"] == launches["scatter_rows"]


def _record(name, source, replaces, launches, err, ms, plain_ms, bound_ms, bound_by, library_ms, **extra) -> dict:
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": launches,
            "max_abs_err": err, "max_err": err, "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms, **extra}


def phase_bwd_times(launches: int, case_err: float) -> dict:
    """The backward kernel at the training shape (bf16), beside the plain
    version's backward and ``scaled_dot_product_attention``'s backward, each
    timed alone on graphs kept for reuse."""
    b, s, t, h, kh, d, causal, window = TRAIN_SHAPE
    q, k, v = rand_qkv(TRAIN_SHAPE, torch.bfloat16, seed=7)
    dout = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(8), device="cuda").to(q.dtype)
    kw = dict(causal=causal, window=window)
    out, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    kernel_ms = median_ms(lambda: fa.flash_attention_bwd_cuda(q, k, v, out, lse, dout, **kw), reps=20)
    on_device_ms = device_ms(lambda: fa.flash_attention_bwd_cuda(q, k, v, out, lse, dout, **kw), "bwd_",
                             per_call=True)
    qr, kr, vr = (x.clone().requires_grad_(True) for x in (q, k, v))
    plain_out = flash_attention_ref(qr, kr, vr, **kw)
    plain_ms = median_ms(lambda: torch.autograd.grad(plain_out, (qr, kr, vr), dout, retain_graph=True), reps=20)
    ql, kl, vl = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    lib_out = torch.nn.functional.scaled_dot_product_attention(ql, kl, vl, is_causal=causal, enable_gqa=True)
    library_ms = median_ms(lambda: torch.autograd.grad(lib_out, (ql, kl, vl), dout.transpose(1, 2),
                                                       retain_graph=True), reps=20)
    # the least work: S again, dP, dV, dK, dQ (5 products of 2d FLOPs per
    # attended pair); q, k, v, o, dout and lse read, dq, dk, dv written
    flops = 10 * d * b * h * attended_pairs(s, t, causal, window)
    nbytes = sum(x.numel() * x.element_size() for x in (q, k, v, out, dout, lse, q, k, v))
    bytes_ms, flops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOP_PER_S * 1e3
    bound_ms = max(bytes_ms, flops_ms)
    log("times", f"flash_attention backward {TRAIN_SHAPE} bf16: kernel {kernel_ms:.4f} ms (its three kernels on "
                 f"the device {on_device_ms:.4f} ms), plain backward "
                 f"{plain_ms:.4f} ms, sdpa backward {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
                 f"({nbytes / 1e6:.1f} MB -> {bytes_ms:.4f} ms; {flops / 1e9:.2f} GFLOP -> {flops_ms:.4f} ms)")
    return _record("flash_attention_bwd", "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                   "src/repro/kernels/flash_attention.py:124 (backward; the TPU kernel has none)", launches,
                   case_err, kernel_ms, plain_ms, bound_ms, "bytes" if bytes_ms >= flops_ms else "operations",
                   library_ms, device_ms=on_device_ms, err_is="max |error| / max |plain gradient| over the cases, bf16")


def phase_quant_times(launches: dict) -> list[dict]:
    """The two quant kernels at the training path's per-layer move (one
    layer row of a stacked moment, fp32 -> int8) and at 4096 scattered
    embedding-moment rows, beside their plain versions and the HBM bound.
    No single PyTorch call computes a per-row absmax-scaled quantization,
    so there is no library time. Rows rotate between calls so that the
    inputs are not left in the 50 MB L2 cache."""
    out = []
    cases = {
        "stacked_row": (STACKED_MOMENT, [[i] for i in range(STACKED_MOMENT[0])]),
        "embed_4096": (EMBED, [[int(x) for x in np.random.default_rng(s).permutation(EMBED[0])[:4096]]
                               for s in range(8)]),
    }
    recs = {}
    for case, (shape, start_sets) in cases.items():
        rows, C = shape
        src = rand_rows(shape, torch.float32, 31) * 1e-3
        dst = torch.zeros(shape, dtype=torch.float32, device="cuda")
        nb = len(start_sets[0])
        turn = [0]

        def nxt():
            turn[0] += 1
            return start_sets[turn[0] % len(start_sets)]

        q, sc = rq.pack_quant_rows_cuda(src, start_sets[0], 1, "int8")
        q_r, sc_r = R.pack_quant_rows_ref(src, start_sets[0], 1, "int8")
        err_pack = float(not (torch.equal(_bytes(q), _bytes(q_r)) and torch.equal(sc, sc_r)))
        a = rq.dequant_scatter_rows_cuda(dst.clone(), q, sc, start_sets[0], 1)
        b = R.dequant_scatter_rows_ref(dst.clone(), q, sc, start_sets[0], 1)
        err_deq = (a - b).abs().max().item()
        del a, b, q_r, sc_r
        timed = {
            "pack_quant_rows": (lambda: rq.pack_quant_rows_cuda(src, nxt(), 1, "int8"),
                                lambda: R.pack_quant_rows_ref(src, nxt(), 1, "int8"),
                                nb * C * (4 + 1) + nb * 4 + nb * 8, err_pack),
            "dequant_scatter_rows": (lambda: rq.dequant_scatter_rows_cuda(dst, q, sc, nxt(), 1),
                                     lambda: R.dequant_scatter_rows_ref(dst, q, sc, nxt(), 1),
                                     nb * C * (1 + 4) + nb * 4 + nb * 8, err_deq),
        }
        for kind, (kernel, plain, nbytes, err) in timed.items():
            kernel_ms = median_ms(kernel, reps=20)
            plain_ms = median_ms(plain, reps=20)
            on_device_ms = device_ms(kernel, "tile_" if kind == "pack_quant_rows" else "dequant_scatter_kernel",
                                     per_call=True)
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
            log("times", f"{kind} {case} ({nb} of {rows} rows x {C} f32 <-> int8): call {kernel_ms:.4f} ms "
                         f"(kernels on the device {on_device_ms:.4f} ms), plain {plain_ms:.4f} ms, library none, "
                         f"bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB), max_abs_err {err:g}")
            assert err == 0.0, f"{kind} disagrees with its plain version at {case}"
            if case == "stacked_row":
                recs[kind] = _record(kind, "src/repro_torch/kernels/csrc/reshard_quant.cu", {
                    "pack_quant_rows": "src/repro/kernels/reshard_quant.py:137",
                    "dequant_scatter_rows": "src/repro/kernels/reshard_quant.py:189"}[kind],
                    launches[kind], err, kernel_ms, plain_ms, bound_ms, "bytes", None,
                    device_ms=on_device_ms, shape=f"{nb} of {rows} rows x {C} f32 <-> int8")
        del src, dst, q, sc
        torch.cuda.empty_cache()
    out = [recs["pack_quant_rows"], recs["dequant_scatter_rows"]]
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    phase_card()
    phase_build()
    phase_kernel_cases()
    phase_small_agreement()
    launches, serve_err = phase_serve()
    record = phase_times(launches, serve_err)
    phase_row_cases()
    elastic_launches = phase_elastic()
    phase_commit_profile()
    rows = phase_row_times(elastic_launches)
    bwd_err = phase_bwd_cases()
    phase_quant_cases()
    train_launches, train_steps = phase_train()
    check_train_launches(train_launches, train_steps)
    bwd = phase_bwd_times(train_launches["flash_attention_bwd"], bwd_err)
    quants = phase_quant_times(train_launches)
    # each record's launches: its counts on the main paths, each counted
    # from zero just before its run and read just after
    paths = {"serve": {"flash_attention": launches}, "elastic": elastic_launches, "train": train_launches}
    records = [record, *rows, bwd, *quants]
    for rec in records:
        rec["launches_by_path"] = {p: counts.get(rec["name"], 0) for p, counts in paths.items()}
        rec["launches"] = sum(rec["launches_by_path"].values())
        assert rec["launches"] > 0 or rec["name"] == "unpack_rows", rec
    log("done", f"{time.perf_counter() - t0:.1f}s")
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
