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
   one PyTorch call each and the HBM bound.
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


def device_ms(fn, kernel: str, calls: int = 10) -> float:
    """Median device time of ``kernel`` (a substring of its name) over
    ``calls`` calls of ``fn``, from ``torch.profiler``: the kernel alone,
    without the host work around its launch."""
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
    return statistics.median(times)


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
    log("done", f"{time.perf_counter() - t0:.1f}s")
    print(json.dumps({"kernels": [record, *rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
