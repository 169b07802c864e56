#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and exits
non-zero without one. Phases, each printing one line or more:

1. card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: every kernel of the port from ``src/repro_torch/kernels/csrc``;
   each library's registers and spills (``-Xptxas -v``), and the count of
   tensor-core instructions (HGMMA for wgmma, HMMA for mma.sync) in each
   flash library's SASS (``cuobjdump -sass``), nonzero for the two
   tensor-core libraries;
3. kernel against its plain version on the card, over the JAX kernel
   tests' shapes, ragged and windowed cases, the serving and the training
   shape, on each route that takes the case (bf16 at head dims 64, 128 and
   256 on the tensor cores and on the CUDA cores; float32 and bf16 at 16
   and 32 on the CUDA cores);
4. small-input agreement: reduced qwen3-1.7b served on the card (kernel)
   and on the CPU (plain path) from the same weights;
5. full-width serve: ``serve_once`` on qwen3-1.7b (28 layers, d_model
   2048), batch 8, prompt 512, 32 greedy tokens; checks that every prefill
   attention went through the kernel on the tensor cores (launch counts,
   in all and by route), that the tokens are
   valid and repeatable, and holds the kernel against the plain version on
   the real q/k/v of the first and last layer; then a ``torch.profiler``
   window over one prefill and 4 decode steps: device time by kernel class
   and the device's busy share;
6. forward times at the serving and the training shape (CUDA events,
   median of 30): the tensor-core kernel and its TFLOP/s, the CUDA-core
   route, the plain version, ``scaled_dot_product_attention`` as a
   yardstick, and the card's bound;
7. the reshard row kernels (pack_rows, scatter_rows, relayout_rows,
   unpack_rows) against their plain versions, byte for byte, on the CPU
   tests' cases in f32/bf16/int8 and at the elastic path's shapes, and the
   refusal of starts that leave the array; scatter_rows and relayout_rows
   at one segment, at the by-value table's capacity and past it (the device
   table, also on a side stream and in more calls than the pinned ring has
   slots), and on overlapping starts, each checked for the table form it
   took and for one launch;
8. elastic serving at full width: qwen3-1.7b, 8 requests of 512-token
   prompts and 32 greedy tokens on dp2tp2, resized mid-generation to
   dp1tp2, dp1tp4 and dp2tp2; params and the live KV cache move through
   the planner, the reshard engine and the row kernels. Checks the launches
   of each commit, every migrated tensor against its source, the staging
   bound, and the tokens against an uninterrupted run; prints each
   commit's pause, plan time, bytes, data-plane rate and peak memory;
9. the data plane of the two byte-moving resizes replayed alone: wall
   time, the host time of each row wrapper per call, and under
   ``torch.profiler`` the device time by kernel class;
10. the row kernels' times (median of 20 calls, CUDA events; and the kernel
   alone on the device, from the profiler; the call's host time is the
   difference) at the elastic path's per-layer move and at 4096 scattered
   embedding rows, beside their plain versions, one PyTorch call each and
   the HBM bound, with the segment table's form; scatter_rows at the
   per-layer move also with a 96 MB write between launches, which evicts
   its staging buffer from the 50 MB L2;
11. the flash-attention backward kernel against autograd of the plain
   version, over the forward's cases and the training shape, f32 and bf16
   (and the serving shape in bf16), on each route that takes the case;
12. the compressed wire's kernels (pack_quant_rows, dequant_scatter_rows)
   against their plain versions, byte for byte, int8 and fp8-e4m3, from
   f32 and bf16: random tiles, the edge tiles (zero, denormal, 3.38e38),
   repeated and overlapping starts, idempotence, and the training path's
   shapes; each route of the scatter's table (a list read by the library,
   sorted or not, an array, blocks it leaves to the wrapper, repeated rows)
   on rows the 16-byte body takes and rows it does not, and the table at
   each form's edge (8160 / 8161 starts, 2720 / 2721 segments), each call
   one launch of the form its table picks; pack_quant_rows on the route
   each tile's size picks (warp, block, grid) at both sides of each
   boundary, and with the edge tiles, repeats, overlaps, quotients at
   half-integers and a NaN tile zero-padded to widths that reach every
   route, each call one launch of the route its size picks; then a float start, in every form, refused with ValueError by
   every row and quant wrapper (the list entries read the list in the
   library), and integer forms and the empty list taken;
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
   every flash launch of the run (forward and backward) on the tensor
   cores; the host time per call of the two quant wrappers over the
   streamed resize, and pack_quant_rows' launches by route;
14. the controller's lifecycle at full width: qwen3-1.7b as in 13, lossless,
   ``WorldPool(capacity=2)``, stream_k 8 (a stream takes 4 rounds): on
   dp2tp2 a speculative build of dp1tp4 (``prefetch_world``) beside a
   streamed resize to dp2tp4; after its first pre-copy round,
   ``retarget_resize`` to dp1tp4 (its Prepare served by the prefetch, the
   commit reusing the streamed layers: every adopted carry the old tensor,
   none aliasing a live one); then back to dp2tp2 from the pool, escalated
   to a stop-copy after one round (``escalate_commit``: fell_back, bytes
   moved). Each commit's state held against the cut, the losses bitwise
   against a control run never resized, the launches of the path, the peak
   memory within 5% of 13's; prints each Prepare's parts, both commits'
   pauses and the stop-copy's rate;
15. the new kernels' times (CUDA events, median of 20): the backward and
   its TFLOP/s beside the CUDA-core route,
   ``scaled_dot_product_attention``'s backward and the plain version's, the
   two quant kernels beside their plain versions, each with its bound
   (pack_quant_rows on each route: a stacked-moment row on the grid route,
   4096 embedding rows on the warp route, 128 tiles of 24 rows on the
   block route);
16. the SSD intra-chunk kernel against its plain version (TF32 off): the
   JAX kernel tests' shapes, reduced mamba2's chunk, a ragged sequence
   through ``ops.ssd_scan``, the serving shape, x in f32 and bf16; and a
   gradient through the card's scan raises;
17. the RMSNorm kernel against its plain version: rows 1-300, d 128, 256,
   2048, 2560, 2561 and 6400 and a misaligned row, f32 and bf16, both
   bodies (the row in registers, and the two-read body for a d above the
   register cap, an odd d and the misaligned row), each case checked for
   the body it took; on aligned rows the register body's bits against the
   two-read body's;
18. small-input agreement: reduced mamba2 with ``d_ff = 0`` served on the
   card (kernel) and on the CPU (plain path) from the same weights;
19. full-width serve of mamba2-2.7b (64 SSD layers, d_model 2560, 80 heads
   of 64, state 128): ``serve_once``, batch 8, prompt 512, 32 greedy
   tokens; exactly 64 SSD launches per prefill, repeatable tokens, the
   kernel against the plain version on the real inputs of the first and
   last layer, and a ``torch.profiler`` window over one prefill and 4
   decode steps;
20. elastic serving of mamba2-2.7b at full width, as phase 8: params and
   the live fp32 ssd/conv cache move at each of three resizes; launches,
   migrated bytes, the staging bound and the tokens checked as there;
21. the two kernels' times (CUDA events, median of 30): the SSD kernel at
   the serving shape (the call, and the kernel alone on the device) beside
   its plain version and three bounds (the bytes, the TF32 tensor-core
   products it issues, the f32 products on the CUDA cores), RMSNorm at (4096, 2560) bf16
   and f32 beside its plain version and ``F.rms_norm`` (the calls in turns,
   the median of 5 medians, and each kernel alone on the device, the
   two-read body's too), each with its bound.
The second-to-last line is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``.

Any failure raises; nothing is caught.
"""

from __future__ import annotations

import dataclasses
import json
import math
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
from repro_torch.kernels import rmsnorm as rms_k  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd_k  # noqa: E402
from repro_torch.kernels.ref import flash_attention_ref  # noqa: E402
from repro_torch.launch.mesh import HBM_BW as HBM_BYTES_PER_S  # noqa: E402
from repro_torch.launch.mesh import PEAK_FLOPS_BF16 as BF16_FLOP_PER_S  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serve import controller as serve_controller  # noqa: E402
from repro_torch.serve.controller import LiveServeController  # noqa: E402
from repro_torch.serve.driver import demo_batch, serve_once  # noqa: E402
from repro_torch.serve.loop import ServeSession  # noqa: E402

# H100 SXM data sheet (HBM3 bandwidth and the dense bf16 peak are the
# port's, from launch/mesh.py): float32 outside the tensor cores, and dense
# TF32 on the tensor cores
F32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12

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
# the training path's attention: batch 4 x 1024 tokens, 16 q / 8 kv heads of 128
TRAIN_SHAPE = (4, 1024, 1024, 16, 8, 128, True, 0)
# the flash libraries and the route each one serves
FLASH_LIBS = {"flash_attention_tc": "tensor_cores", "flash_attention_bwd_tc": "tensor_cores",
              "flash_attention": "cuda_cores", "flash_attention_bwd": "cuda_cores"}


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def rand_qkv(case, dtype, seed):
    b, s, t, h, kh, d, _, _ = case
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda *shape: torch.randn(shape, generator=g, device="cuda").to(dtype)  # noqa: E731
    return mk(b, s, h, d), mk(b, t, kh, d), mk(b, t, kh, d)


def routes(dtype, d) -> list[str]:
    """Every route that takes (dtype, head dim): the CUDA cores take all,
    the tensor cores bf16 at their head dims."""
    return ["tensor_cores", "cuda_cores"] if fa.route(dtype, d) == "tensor_cores" else ["cuda_cores"]


def kernel_vs_plain(q, k, v, route=None, **kw) -> float:
    out = fa.flash_attention_cuda(q, k, v, route=route, **kw)
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
    # which instructions carry the flash products: wgmma is HGMMA in SASS,
    # mma.sync HMMA; the CUDA-core route has neither
    cuobjdump = Path(build.nvcc()).parent / "cuobjdump"
    for name, route in FLASH_LIBS.items():
        sass = subprocess.run([str(cuobjdump), "-sass", str(libs[name])], capture_output=True, text=True,
                              check=True, timeout=120).stdout
        hgmma, hmma = sass.count("HGMMA"), sass.count("HMMA")
        log("build", f"{name} ({route}): SASS has {hgmma} HGMMA and {hmma} HMMA instructions")
        if route == "tensor_cores":
            assert hgmma + hmma > 0, f"{name}: no tensor-core instruction in its SASS"


def phase_kernel_cases() -> None:
    for dtype in (torch.float32, torch.bfloat16):
        for i, case in enumerate(FLASH_CASES + ([SLICE_SHAPE, TRAIN_SHAPE] if dtype == torch.bfloat16 else [])):
            q, k, v = rand_qkv(case, dtype, seed=i)
            for route in routes(dtype, case[5]):
                before = (fa.tc_launches, fa.cc_launches)
                err = kernel_vs_plain(q, k, v, route=route, causal=case[6], window=case[7])
                assert (fa.tc_launches - before[0], fa.cc_launches - before[1]) == (
                    (1, 0) if route == "tensor_cores" else (0, 1)), f"{route} was not the route launched"
                log("kernel", f"flash_attention {case} {str(dtype)[6:]} {route}: max_abs_err {err:.3e} "
                              f"(tol {TOL[dtype]:g})")
                assert err <= TOL[dtype], f"kernel ({route}) disagrees with plain version on {case}: {err}"
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
    for x, why in [(q, "float32 on the tensor cores"),
                   (q[..., :32].contiguous().bfloat16(), "head dim 32 on the tensor cores")]:
        try:
            fa.flash_attention_cuda(x, x, x, route="tensor_cores")
        except ValueError:
            log("kernel", f"refused {why}")
        else:
            raise AssertionError(f"kernel accepted {why}")


def phase_small_agreement(cfg=None, prompt_len: int = 96) -> None:
    """A reduced model in f32 (qwen3 unless ``cfg`` is given), the same
    weights on the card and on the CPU: the card's path (kernels) against
    the CPU's (plain versions)."""
    cfg = cfg or get_config("qwen3-1.7b").reduced()
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    gpu = _to(params, "cuda")
    tokens = torch.randint(0, cfg.vocab_size, (2, prompt_len), generator=torch.Generator().manual_seed(1))
    worst, same = 0.0, True
    with torch.inference_mode():
        lc, cc, _ = M.prefill(cfg, params, {"tokens": tokens}, torch.float32, prompt_len + 4)
        lg, cg, _ = M.prefill(cfg, gpu, {"tokens": tokens.cuda()}, torch.float32, prompt_len + 4)
        for i in range(4):
            worst = max(worst, (lg.cpu() - lc).abs().max().item())
            tc, tg = lc[:, -1].argmax(-1, keepdim=True), lg[:, -1].argmax(-1, keepdim=True)
            same &= torch.equal(tc, tg.cpu())
            lc, cc = M.decode_step(cfg, params, cc, tc, prompt_len + i)
            lg, cg = M.decode_step(cfg, gpu, cg, tg, prompt_len + i)
    log("agree", f"{cfg.name} (d_ff {cfg.d_ff}) f32, prompt {prompt_len}, card vs CPU: max logit diff "
                 f"{worst:.3e}, greedy tokens equal {same}")
    assert worst <= 1e-3 and same, "card and CPU paths disagree"


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device) for k, v in tree.items()}


def phase_serve() -> tuple[int, float]:
    cfg = get_config("qwen3-1.7b")
    torch.cuda.reset_peak_memory_stats()
    fa.launches = fa.tc_launches = fa.cc_launches = 0  # the main path's counts start here
    out = serve_once(cfg, device="cuda", seed=0, **SERVE)
    launches, tc_launches = fa.launches, fa.tc_launches  # ... and are read here
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    toks = out["tokens"]
    tok_s = SERVE["batch"] * SERVE["gen"] / out["decode_s"]
    log("serve", f"{cfg.name} full width ({cfg.num_layers} layers, d_model {cfg.d_model}), batch "
                 f"{SERVE['batch']} x prompt {SERVE['prompt_len']}, {SERVE['gen']} greedy tokens: "
                 f"prefill_s {out['prefill_s']:.4f}, decode_s {out['decode_s']:.4f} "
                 f"({tok_s:.1f} tok/s), peak memory {peak_gb:.2f} GB, flash launches {launches}")
    assert launches == cfg.num_layers, f"{launches} flash launches, want {cfg.num_layers}"
    # qwen3's attention is bf16 at head dim 128: every launch on the tensor cores
    assert fa.route(getattr(torch, cfg.dtype), cfg.resolved_head_dim) == "tensor_cores"
    assert tc_launches == launches, f"{tc_launches} of {launches} flash launches on the tensor cores"
    log("serve", f"flash launches by route: tensor_cores {tc_launches}, cuda_cores {launches - tc_launches}")
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
        case = (*q.shape[:2], k.shape[1], q.shape[2], k.shape[2], q.shape[3], kw["causal"], kw["window"])
        rel = bwd_vs_plain(case, q.dtype, seed=i, qkv=(q, k, v), scale=kw["scale"])
        log("serve", f"layer {i} prefill attention {tuple(q.shape)} {str(q.dtype)[6:]}: kernel vs "
                     f"plain max_abs_err {err:.3e}; backward max |error| / max |plain| {rel:.3e}")
        assert err <= TOL[q.dtype] and rel <= BWD_TOL[q.dtype]
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
    if "fa_fwd" in name:
        return "flash"
    if "ssd_intra_chunk_kernel" in name:
        return "ssd"
    if any(tag in name.lower() for tag in ("gemm", "gemv", "xmma", "cutlass", "cublas", "nvjet")):
        return "matmul"
    return "other"


# Two faults of the profiler on the H100 machines, seen in chip_smoke.py's
# own traces. It loses some device records of a trace: the first launch's
# after the serving phases (nine of ten pack_rows kernels, the first one
# missing, in every trace), and one or two of ten in the later phases, so a
# trace opens with a spin kernel that no measurement reads, and device_ms
# takes the first of TRACE_TRIES traces that holds every event it expects,
# else the fullest. And it keeps a device event only where the event falls
# inside the trace's window on the host clock, from which the card's clock
# drifts (a kernel can show before its own launch), so a trace waits
# TRACE_PAD_S on the host before its first call and after its last. TRACES
# counts the traces taken, those that were not whole, and the measurements
# that had to use such a trace.
TRACE_PAD_S = 0.1
TRACE_TRIES = 3
TRACES = {"taken": 0, "not whole": 0, "used not whole": 0}
SPIN_KERNEL = "spin_kernel"  # torch.cuda._sleep's


def open_trace() -> None:
    """The start of every trace: the wait, then the spin kernel, finished."""
    time.sleep(TRACE_PAD_S)
    torch.cuda._sleep(100)
    torch.cuda.synchronize()


def device_events(prof) -> list:
    """The device events of a trace but its opening spin kernel's."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and SPIN_KERNEL not in e.name]


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
            open_trace()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            time.sleep(TRACE_PAD_S)
        busy = {"flash": 0.0, "ssd": 0.0, "matmul": 0.0, "other": 0.0}
        by_name: dict[str, float] = {}
        count = 0
        for e in device_events(prof):
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
                       f"flash {busy['flash']:.3f} ms, ssd {busy['ssd']:.3f} ms, other {busy['other']:.3f} ms")
        for kname, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
            log("profile", f"  {name}: {ms:8.3f} ms  {kname[:110]}")


def _fwd_times(shape) -> dict:
    """The forward at ``shape`` (bf16): each route, the plain version and
    ``scaled_dot_product_attention`` (CUDA events, median of 30), the
    bound, and the tensor-core kernel's achieved rate."""
    b, s, t, h, kh, d, causal, window = shape
    q, k, v = rand_qkv(shape, torch.bfloat16, seed=99)
    kw = dict(causal=causal, window=window)
    err = kernel_vs_plain(q, k, v, **kw)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    kernel_ms = median_ms(lambda: fa.flash_attention_cuda(q, k, v, **kw))
    cuda_cores_ms = median_ms(lambda: fa.flash_attention_cuda(q, k, v, route="cuda_cores", **kw))
    plain_ms = median_ms(lambda: flash_attention_ref(q, k, v, **kw))
    library = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=causal, enable_gqa=True)
    library_ms = median_ms(library)
    # the kernels alone on the device (torch.profiler), without the host
    # work around each call: ours, and every kernel of the library call
    on_device_ms = device_ms(lambda: fa.flash_attention_cuda(q, k, v, **kw), "fa_fwd_tc")
    library_device_ms = device_ms(library, "", per_call=True)
    nbytes = sum(x.numel() * x.element_size() for x in (q, k, v, q))  # q, k, v in; o out
    flops = 4 * d * b * h * attended_pairs(s, t, causal, window)  # QK^T and PV
    bytes_ms, flops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOP_PER_S * 1e3
    bound_ms = max(bytes_ms, flops_ms)
    tflops = flops / kernel_ms / 1e9
    log("times", f"flash_attention {shape} bf16: kernel {kernel_ms:.4f} ms ({tflops:.1f} TFLOP/s; on the device "
                 f"{on_device_ms:.4f} ms), the CUDA-core route {cuda_cores_ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
                 f"{library_ms:.4f} ms (on the device {library_device_ms:.4f} ms), bound "
                 f"{bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB -> {bytes_ms:.4f} ms; {flops / 1e9:.2f} GFLOP -> "
                 f"{flops_ms:.4f} ms)")
    return {"err": err, "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations", "tflops": tflops,
            "cuda_cores_ms": cuda_cores_ms, "device_ms": on_device_ms, "library_device_ms": library_device_ms}


def phase_times(launches: int, serve_err: float) -> dict:
    """The forward at the serving shape (the record's numbers) and at the
    training shape (kept in the record beside them)."""
    serve, train = _fwd_times(SLICE_SHAPE), _fwd_times(TRAIN_SHAPE)
    max_err = max(serve["err"], train["err"], serve_err)  # these shapes and the serve phase's real layers
    # the record carries both the smoke contract's key names (ms,
    # max_abs_err) and the issue's (kernel_ms, max_err)
    return {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_tc.cu",
        "sources": {"tensor_cores": "src/repro_torch/kernels/csrc/flash_attention_tc.cu",
                    "cuda_cores": "src/repro_torch/kernels/csrc/flash_attention.cu"},
        "replaces": "src/repro/kernels/flash_attention.py:124",
        "launches": launches,
        "max_abs_err": max_err,
        "max_err": max_err,
        "ms": serve["ms"],
        "kernel_ms": serve["ms"],
        "plain_ms": serve["plain_ms"],
        "bound_ms": serve["bound_ms"],
        "bound_by": serve["bound_by"],
        "library_ms": serve["library_ms"],
        "tflops": serve["tflops"],
        "cuda_cores_ms": serve["cuda_cores_ms"],
        "device_ms": serve["device_ms"],
        "library_device_ms": serve["library_device_ms"],
        "shape": list(SLICE_SHAPE),
        "train_shape": {k: v for k, v in train.items() if k != "err"} | {"shape": list(TRAIN_SHAPE)},
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
    phase_table_forms()
    src = rand_rows((64, 8), torch.float32, 0)
    bad = {
        "pack_rows start 64": (lambda: rp.pack_rows_cuda(src, [64], 1), ValueError),
        "pack_rows start -1 among 3": (lambda: rp.pack_rows_cuda(src, [0, 5, -1], 1), ValueError),
        "pack_rows start 1.5": (lambda: rp.pack_rows_cuda(src, [0, 1.5], 1), ValueError),
        "pack_rows start 2**70": (lambda: rp.pack_rows_cuda(src, [2**70], 1), ValueError),
        "scatter_rows start -1": (lambda: rp.scatter_rows_cuda(src, src[:1], [-1], 1), ValueError),
        "relayout_rows block past the end": (lambda: rp.relayout_rows_cuda(src, src.clone(), [63], 2), ValueError),
        "unpack_rows start 64": (lambda: rp.unpack_rows_cuda(src[:1], [64], 1, 64), ValueError),
    }
    before = dict(rp.launches)
    for why, (call, error) in bad.items():
        try:
            call()
        except error:
            log("rows", f"refused {why} ({error.__name__})")
        else:
            raise AssertionError(f"row kernel accepted {why}")
    assert rp.launches == before, "a refused call launched"


def _forms_since(before: dict) -> dict:
    """The table forms of the row kernels' launches since ``before`` (a
    copy of ``rp.table_launches``), with their counts."""
    return {k: rp.table_launches[k] - before[k] for k in before if rp.table_launches[k] != before[k]}


def phase_table_forms() -> None:
    """The row kernels against their plain versions, byte for byte, with
    their table at each form's edge: scatter_rows and relayout_rows at one
    segment, exactly the by-value capacity of segments, one past it (the
    device table), and on overlapping starts; pack_rows and unpack_rows at
    one block, exactly the by-value capacity of starts, one past it, and
    unpack_rows on overlapping starts (segments, by value and past the
    capacity). Each call must launch once, with the form its size picks.
    Then tables past the capacities in more calls than the pinned ring has
    slots, on the default and on a side stream, with no synchronisation
    between them. Last, what a pack_rows call costs at each size class."""
    cap, scap = rp.PARAM_SEGS, rp.PARAM_STARTS
    C = 2048
    rng = np.random.default_rng(5)
    spaced = lambda n: [int(x) for x in rng.permutation(n) * 2]  # noqa: E731  n disjoint, unsorted blocks
    cases = {
        "scatter_rows": {
            "one segment": ([7], 1, "param"),
            "by-value capacity": (spaced(cap), 1, "param"),
            "one past it": (spaced(cap + 1), 1, "device"),
            "overlapping starts": (OVERLAP_STARTS[0], 8, "param"),
            "overlapping starts, reversed": (OVERLAP_STARTS[1], 8, "param"),
        },
        "pack_rows": {
            "one block": ([7], 1, "starts"),
            "by-value capacity": (spaced(scap), 1, "starts"),
            "one past it": (spaced(scap + 1), 1, "starts_device"),
            "overlapping starts": (OVERLAP_STARTS[0], 8, "starts"),
            "by-value capacity, as an array": (np.array(spaced(scap)), 1, "starts"),
        },
    }
    cases["relayout_rows"] = cases["scatter_rows"]
    cases["unpack_rows"] = {
        **{k: v for k, v in cases["pack_rows"].items() if "overlapping" not in k},
        "overlapping starts": (OVERLAP_STARTS[0], 8, "param"),
        "overlapping starts, reversed": (OVERLAP_STARTS[1], 8, "param"),
        "overlapping starts past the segment capacity": (spaced(cap + 1) + [0], 1, "device"),
    }
    for kind in ("scatter_rows", "relayout_rows", "pack_rows", "unpack_rows"):
        rows = 2 * ((cap if kind in ("scatter_rows", "relayout_rows") else scap) + 1) + 1
        for why, (starts, block, form) in cases[kind].items():
            before, forms_before = rp.launches[kind], dict(rp.table_launches)
            row_kernel_vs_plain(kind, rows, C, torch.bfloat16, starts, block, 31)
            forms = _forms_since(forms_before)
            assert forms == {form: 1} and rp.launches[kind] == before + 1, (kind, why, forms)
        log("rows", f"{kind}: equal, one launch each, form as its size picks: "
                    + ", ".join(f"{why} ({len(st)} starts, {form})" for why, (st, _, form) in cases[kind].items())
                    + f" ({rows} x {C} bf16)")
    # tables past the capacities, queued back to back: the ring's slots and
    # the per-stream device tables are reused while earlier calls still run
    side = torch.cuda.Stream()
    calls = 3 * rp._RING_SLOTS
    rows = 2 * (scap + calls) + 1
    src, base = rand_rows((rows, C), torch.bfloat16, 32), rand_rows((rows, C), torch.bfloat16, 33)
    jobs = []
    for i in range(calls):
        segs = [int(x) for x in np.random.default_rng(40 + i).permutation(cap + 1 + i) * 2]
        starts = [int(x) for x in np.random.default_rng(60 + i).permutation(scap + 1 + i) * 2]
        buf = rand_rows((len(segs), C), torch.bfloat16, 50 + i)
        stream = side if i % 3 == 2 else torch.cuda.current_stream()
        if stream is side:
            side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            got = (rp.scatter_rows_cuda(base.clone(), buf, segs, 1), rp.relayout_rows_cuda(base.clone(), src, segs, 1),
                   rp.pack_rows_cuda(src, starts, 1))
            got += (rp.unpack_rows_cuda(got[2], starts, 1, rows),)
        jobs.append((segs, starts, buf, got))
    torch.cuda.synchronize()
    for segs, starts, buf, (got_s, got_r, got_p, got_u) in jobs:
        assert torch.equal(got_s, R.scatter_rows_ref(base.clone(), buf, segs, 1)), len(segs)
        assert torch.equal(got_r, R.relayout_rows_ref(base.clone(), src, segs, 1)), len(segs)
        want_p = R.pack_rows_ref(src, starts, 1)
        assert torch.equal(got_p, want_p), len(starts)
        assert torch.equal(got_u, R.unpack_rows_ref(want_p, starts, 1, rows)), len(starts)
    log("rows", f"{len(jobs)} back-to-back calls of each kernel past its capacity ({cap + 1}-{cap + len(jobs)} "
                f"segments, {scap + 1}-{scap + len(jobs)} starts, {rp._RING_SLOTS} pinned slots, a third on a "
                "side stream): equal to the plain versions")
    del src, base, jobs
    # a pack_rows call at each size class of its starts, on narrow rows so
    # that the call is mostly the host's work and the launch
    src = rand_rows((2 * scap + 2, 64), torch.bfloat16, 34)
    costs = []
    for n in (1, 16, 17, 256, 257, 4096, scap, scap + 1):
        starts = [int(x) for x in np.random.default_rng(n).permutation(n) * 2]
        forms_before = dict(rp.table_launches)
        ms = median_ms(lambda: rp.pack_rows_cuda(src, starts, 1), reps=50)
        costs.append(f"{n} starts {ms:.4f} ms ({'/'.join(_forms_since(forms_before))})")
    log("rows", "pack_rows call by size class of its starts (rows of 64 bf16, median of 50): " + ", ".join(costs))


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


def phase_elastic(arch: str = "qwen3-1.7b") -> dict:
    """``arch`` (qwen3-1.7b, or mamba2-2.7b) at full width serves 8
    requests (512-token prompts, 32 greedy tokens) on dp2tp2 and resizes
    three times mid-generation; params and the live cache (KV, or the SSD
    and conv states) move through the planner, the engine and the row
    kernels. A wrapper around ``live_reshard_planned`` counts each commit's
    launches, checks every migrated tensor against its source byte for byte
    and the staging bound. Tokens must equal an uninterrupted run."""
    cfg = get_config(arch)
    mixer = "ssd_intra_chunk" if cfg.family == "ssm" else "flash_attention"
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
        fa.launches = ssd_k.launches = 0  # the elastic path's counts start here ...
        for k in rp.launches:
            rp.launches[k] = 0
        results, metrics, records = elastic_session(cfg, prompts, ELASTIC_TRACE)
        # ... and are read here
        launches = {"flash_attention": fa.launches, "ssd_intra_chunk": ssd_k.launches, **rp.launches}
    finally:
        serve_controller.live_reshard_planned, ops.relayout_rows = orig_reshard, orig_relayout
    plain, _, _ = elastic_session(cfg, prompts, [])
    state_gb = sum(s.nbytes for s in serve_controller.serve_state_specs(
        cfg, ELASTIC["n_slots"], ELASTIC["max_seq"], torch.bfloat16)) / 1e9
    log("elastic", f"{cfg.name} full width (serving state {state_gb:.4f} GB), {ELASTIC['n_slots']} requests x prompt {ELASTIC['prompt_len']}, "
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
    assert launches[mixer] == cfg.num_layers, launches  # one wave, one prefill
    assert launches["flash_attention"] + launches["ssd_intra_chunk"] == cfg.num_layers, launches
    assert all(launches[k] == sum(c["launched"][k] for c in commits) for k in ROW_KERNELS)
    assert results == plain, "the resized run's tokens differ from the uninterrupted run's"
    assert all(0 <= t < cfg.vocab_size for toks in results.values() for t in toks)
    assert all(len(toks) == ELASTIC["gen"] for toks in results.values()) and len(results) == ELASTIC["n_slots"]
    log("elastic", "tokens equal the uninterrupted dp2tp2 run; every migrated tensor equals its source")
    return launches


def device_ms(fn, kernel, calls: int = 10, per_call=False) -> float:
    """Median device time of ``kernel`` (a substring of its name, or a
    tuple of them) over ``calls`` calls of ``fn``, from ``torch.profiler``:
    the kernel alone, without the host work around its launch.
    ``per_call``: the device time of a call that launches several kernels
    (or a memset and a kernel): each matching kernel's mean time, times its
    launches a call, summed. The launches a call are the wrapper's, where
    ``per_call`` is a function that reads its launch count (each matching
    kernel runs once a counted launch), else each kernel's events over the
    calls, rounded up (a call's kernels are the same in every call). On a
    whole trace this is every matching event's time over the calls, and it
    does not fall where a trace loses a few events. A trace is whole when
    every name matched, with at least one matching event a call (a counted
    launch, where the count is read), and a kernel on the device for every
    launch the host made in it; the first whole trace of TRACE_TRIES is
    used, else the one with the most matching events."""
    from torch.profiler import ProfilerActivity, profile

    names = (kernel,) if isinstance(kernel, str) else kernel
    fn()
    torch.cuda.synchronize()
    best = None
    for _ in range(TRACE_TRIES):
        counted = per_call() if callable(per_call) else 0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            open_trace()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            time.sleep(TRACE_PAD_S)
        expected = calls
        if callable(per_call):
            counted = (per_call() - counted) / calls
            assert counted > 0, "the wrapper counted no launch"
            expected = round(counted * calls)
        by_kernel: dict[str, list[float]] = {}
        events = device_events(prof)
        kernels = sum(not e.name.startswith(("Memset", "Memcpy")) for e in events)
        # the host's launches but the spin kernel's
        host_launches = sum(e.device_type != torch.autograd.DeviceType.CUDA
                            and ("LaunchKernel" in e.name or "LaunchCooperativeKernel" in e.name)
                            for e in prof.events()) - 1
        for e in events:
            if any(name in e.name for name in names):
                by_kernel.setdefault(e.name, []).append(e.time_range.elapsed_us() / 1e3)
        n_events = sum(len(ts) for ts in by_kernel.values())
        TRACES["taken"] += 1
        if best is None or n_events > best[0]:
            best = (n_events, by_kernel, counted)
        if (all(any(name in k for k in by_kernel) for name in names) and n_events >= expected
                and kernels >= host_launches):
            break
        TRACES["not whole"] += 1
        log("profile", f"a trace of {names} held {n_events} of {expected} events, {kernels} kernels of "
                       f"{host_launches} launches")
    else:
        TRACES["used not whole"] += 1
        log("profile", f"no whole trace of {names} in {TRACE_TRIES}: the one of {best[0]} events is used")
    n_events, by_kernel, counted = best
    missed = [name for name in names if not any(name in k for k in by_kernel)]
    assert not missed, f"the profiler saw no {missed}"
    times = [t for ts in by_kernel.values() for t in ts]
    if not per_call:
        return statistics.median(times)
    if not callable(per_call):
        return sum(statistics.fmean(ts) * math.ceil(len(ts) / calls) for ts in by_kernel.values())
    return counted * sum(statistics.fmean(ts) for ts in by_kernel.values())


def _device_class(name: str) -> str:
    for kind in ROW_KERNELS:
        if f"{kind}_kernel" in name:
            return kind
    if "Memcpy" in name:
        return "memcpy"
    if "fill" in name.lower() or "Memset" in name:
        return "zero-fill"
    return "other"


class _wrapper_clocks:
    """Within the block, times every call of the CUDA wrappers of ``kinds``
    in ``module`` (the row kernels' by default) on the host clock:
    ``host[kind] = [calls, seconds]`` accumulate."""

    def __init__(self, host: dict, module=rp, kinds=ROW_KERNELS):
        self.host, self.module, self.kinds, self.saved = host, module, kinds, {}

    def __enter__(self):
        for kind in self.kinds:
            fn = self.saved[kind] = getattr(self.module, f"{kind}_cuda")

            def timed(*args, _fn=fn, _kind=kind):
                t0 = time.perf_counter()
                out = _fn(*args)
                self.host[_kind][1] += time.perf_counter() - t0
                self.host[_kind][0] += 1
                return out

            setattr(self.module, f"{kind}_cuda", timed)

    def __exit__(self, *exc):
        for kind, fn in self.saved.items():
            setattr(self.module, f"{kind}_cuda", fn)


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
        host = {k: [0, 0.0] for k in ROW_KERNELS}  # calls, wrapper seconds, over the timed runs
        for _ in range(3):
            torch.cuda.synchronize()
            with _wrapper_clocks(host):
                t0 = time.perf_counter()
                dst, stats = live_reshard_planned(specs, plan, state, *worlds)
                walls.append(time.perf_counter() - t0)
            del dst
        before = dict(rp.launches)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            open_trace()
            t0 = time.perf_counter()
            dst, stats = live_reshard_planned(specs, plan, state, *worlds)
            wall_ms = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            time.sleep(TRACE_PAD_S)
        launched = sum(rp.launches[k] - before[k] for k in before)
        assert all(torch.equal(dst[n], state[n]) for n in dst)
        del dst
        busy: dict[str, float] = {}
        for e in device_events(prof):
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
        wall_s = sum(walls)
        wrapped_s = sum(sec for _, sec in host.values())
        log("commit", f"{ca.describe()} -> {cb.describe()} host by kernel (the 3 timed runs, no profiler): "
                      + ", ".join(f"{k} {calls // 3} calls, wrapper {1e3 * sec / calls:.4f} ms per call, device "
                                  f"{busy.get(k, 0.0) / max(calls // 3, 1):.4f} ms per launch"
                                  for k, (calls, sec) in host.items() if calls)
                      + f"; outside the wrappers {1e3 * (wall_s - wrapped_s) / 3:.3f} ms per run of "
                        f"{1e3 * wall_s / 3:.3f} ms")
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
            forms_before = dict(rp.table_launches)
            kernel_ms = median_ms(kernel, reps=20)
            forms = _forms_since(forms_before)
            form = "/".join(forms)
            plain_ms = median_ms(plain, reps=20)
            library_ms = median_ms(library, reps=20)
            if kind == "unpack_rows":  # the entry's zero-fill of the output, then the kernel
                on_device_ms = device_ms(kernel, ("Memset", f"{kind}_kernel"),
                                         per_call=lambda: rp.launches["unpack_rows"])
            else:
                on_device_ms = device_ms(kernel, f"{kind}_kernel")
            nbytes = _row_bytes_moved(kind, C, nb, 1, rows, 2)
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
            log("times", f"{kind} {case} ({nb} of {rows} rows x {C} bf16): call {kernel_ms:.4f} ms (kernel "
                         f"on the device {on_device_ms:.4f} ms, {nbytes / on_device_ms / 1e6:.0f} GB/s; host "
                         f"{kernel_ms - on_device_ms:.4f} ms, table {form}), plain {plain_ms:.4f} ms, library "
                         f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB), "
                         f"max_abs_err {err:g}")
            assert len(forms) == 1, forms
            assert err == 0.0, f"{kind} disagrees with its plain version at {case}"
            flushed_ms = None
            if kind == "scatter_rows" and case == "cache_row":
                # the same calls with a write larger than the 50 MB L2
                # between launches: the staging row (8.9 MB) is read from
                # HBM, not from the L2 the previous call left it in
                flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")

                def flushed():
                    flush.fill_(1)
                    return kernel()

                flushed_ms = device_ms(flushed, f"{kind}_kernel")
                del flush
                log("times", f"{kind} {case} on the device: {on_device_ms:.4f} ms with the staging row in L2 "
                             f"(as the commit's pack_rows leaves it), {flushed_ms:.4f} ms after a 96 MB write "
                             f"between launches (bound {bound_ms:.4f} ms, each byte once from HBM)")
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
                    "host_ms": kernel_ms - on_device_ms,
                    "table": form,
                    "plain_ms": plain_ms,
                    "bound_ms": bound_ms,
                    "bound_by": "bytes",
                    "library_ms": library_ms,
                    "shape": f"{nb} of {rows} rows x {C} bf16",
                }
                if flushed_ms is not None:
                    rec["device_ms_l2_flushed"] = flushed_ms
            del src, dst, buf, idx
            torch.cuda.empty_cache()
        out.append(rec)
    return out


# ---------------------------------------------------------------------------
# Slice 3: the backward kernel, the compressed wire, live-resized training
# ---------------------------------------------------------------------------

# relative to the largest plain-version gradient: f32 sums in another order
# over up to 1024 rows; bf16 rounds the kernel's output and dq/dk/dv once
BWD_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
TRAIN = dict(arch="qwen3-1.7b", batch=4, seq=1024, before=3, after=3, stream_k=8, device="cuda")
QUANT_FORMATS = ("int8", "fp8_e4m3")
QUANT_KERNELS = ("pack_quant_rows", "dequant_scatter_rows")
STACKED_MOMENT = (28, 2048 * 6144)  # a stacked moment of qwen3-1.7b (mlp/wi_gate), one row a layer


def bwd_vs_plain(case, dtype, seed, route=None, qkv=None, scale=None) -> float:
    """The backward kernel of ``route`` (through the autograd Function)
    against autograd of the plain version on the same inputs (``qkv``, or
    random ones of ``case``) and a random output gradient: the largest
    |error| over dq, dk, dv, relative to the largest plain value."""
    q, k, v = qkv if qkv is not None else rand_qkv(case, dtype, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1000)
    dout = torch.randn(q.shape, generator=g, device="cuda").to(dtype)
    kw = dict(causal=case[6], window=case[7], scale=scale)
    before = (fa.bwd_launches, fa.tc_bwd_launches)
    qk, kk, vk = (x.clone().requires_grad_(True) for x in (q, k, v))
    got = torch.autograd.grad(fa.flash_attention(qk, kk, vk, route=route, **kw), (qk, kk, vk), dout)
    qr, kr, vr = (x.clone().requires_grad_(True) for x in (q, k, v))
    want = torch.autograd.grad(flash_attention_ref(qr, kr, vr, **kw), (qr, kr, vr), dout)
    torch.cuda.synchronize()
    assert fa.bwd_launches == before[0] + 1, "the autograd Function did not launch the backward kernel"
    on_tc = (route or fa.route(dtype, case[5])) == "tensor_cores"
    assert fa.tc_bwd_launches == before[1] + on_tc, "the backward ran on another route"
    worst, scale = 0.0, 0.0
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape and torch.isfinite(a.float()).all()
        worst = max(worst, (a.float() - b.float()).abs().max().item())
        scale = max(scale, b.float().abs().max().item())
    return worst / scale


def phase_bwd_cases() -> float:
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for i, case in enumerate(FLASH_CASES + [TRAIN_SHAPE] + ([SLICE_SHAPE] if dtype == torch.bfloat16 else [])):
            for route in routes(dtype, case[5]):
                rel = bwd_vs_plain(case, dtype, seed=100 + i, route=route)
                log("bwd", f"flash_attention backward {case} {str(dtype)[6:]} {route}: max |error| / max |plain| "
                           f"{rel:.3e} over dq, dk, dv (tol {BWD_TOL[dtype]:g})")
                assert rel <= BWD_TOL[dtype], \
                    f"backward kernel ({route}) disagrees with autograd of the plain version on {case}"
                worst = max(worst, rel) if dtype == torch.bfloat16 else worst
    return worst


def _bytes(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.uint8)


def _quant_forms_since(before: dict) -> dict:
    """The table forms of dequant_scatter_rows' launches since ``before`` (a
    copy of ``rq.table_launches``), with their counts."""
    return {k: rq.table_launches[k] - before[k] for k in before if rq.table_launches[k] != before[k]}


def pack_vs_plain(src, starts, block_rows, fmt):
    """pack_quant_rows against its plain version, byte for byte (payload
    and scales). Returns (payload, scales, plain payload, plain scales, the
    route), after checking that the call was one launch of the route that
    :func:`rq.route` picks for its tiles."""
    before = dict(rq.route_launches)
    q, s = rq.pack_quant_rows_cuda(src, starts, block_rows, fmt)
    q_r, s_r = R.pack_quant_rows_ref(src, starts, block_rows, fmt)
    torch.cuda.synchronize()
    took = [k for k in before if rq.route_launches[k] != before[k]]
    assert len(took) == 1 and rq.route_launches[took[0]] == before[took[0]] + 1, took
    assert took[0] == rq.route(block_rows * src.shape[1], src.element_size()), took
    what = f"({fmt}, {src.dtype}, {tuple(src.shape)}, {block_rows}-row tiles, route {took[0]})"
    assert torch.equal(_bytes(q), _bytes(q_r)), f"pack_quant_rows payload differs {what}"
    assert torch.equal(_bytes(s), _bytes(s_r)), f"pack_quant_rows scales differ {what}"
    return q, s, q_r, s_r, took[0]


def quant_vs_plain(src, starts, block_rows, fmt, dst=None) -> str:
    """Both quant kernels against their plain versions, byte for byte:
    payload and scales (:func:`pack_vs_plain`), the dequantized scatter into
    ``dst`` (repeated starts included) and its idempotence. Returns the form
    of the scatter's table, after checking that each scatter launched once."""
    q, s, q_r, s_r, _ = pack_vs_plain(src, starts, block_rows, fmt)
    dst = torch.zeros_like(src) if dst is None else dst
    before = dict(rq.table_launches)
    once = rq.dequant_scatter_rows_cuda(dst.clone(), q, s, starts, block_rows)
    forms = _quant_forms_since(before)
    want = R.dequant_scatter_rows_ref(dst.clone(), q_r, s_r, starts, block_rows)
    twice = rq.dequant_scatter_rows_cuda(once.clone(), q, s, starts, block_rows)
    torch.cuda.synchronize()
    assert torch.equal(_bytes(once), _bytes(want)), f"dequant_scatter_rows differs ({fmt}, {src.dtype})"
    assert torch.equal(_bytes(twice), _bytes(once)), "dequant_scatter_rows is not idempotent"
    assert len(forms) == 1 and sum(forms.values()) == 1, forms
    return next(iter(forms))


def phase_quant_cases() -> None:
    rng = np.random.default_rng(3)
    for fmt in QUANT_FORMATS:
        for dtype in (torch.float32, torch.bfloat16):
            n, forms = 0, {}
            for seed in range(6):
                rows, C = int(rng.integers(8, 64)), int(rng.choice([1, 3, 128, 130, 4096]))
                block = int(rng.choice([1, 2, 8])) if rows >= 16 else 1
                nb = int(rng.integers(1, rows // block + 1))
                starts = [int(x) for x in rng.integers(0, rows - block + 1, nb)]  # repeats, overlaps
                src = rand_rows((rows, C), dtype, seed) * float(10.0 ** rng.integers(-30, 30))
                form = quant_vs_plain(src, starts, block, fmt, rand_rows((rows, C), dtype, seed + 1))
                forms[form] = forms.get(form, 0) + 1
                n += 1
            edge = torch.tensor([[0.0] * 128, [1e-40] * 128, [3.38e38] * 128], device="cuda").to(dtype)
            assert quant_vs_plain(edge, [0, 1, 2], 1, fmt, torch.ones_like(edge)) == "starts"
            # repeated: the last wins
            assert quant_vs_plain(edge, [2, 0, 2, 1, 0], 1, fmt, torch.ones_like(edge)) == "param"
            log("quant", f"{fmt} from {str(dtype)[6:]}: {n} random cases (C 1..4096, blocks 1/2/8, repeated and "
                         f"overlapping starts; scatter tables {forms}) and the edge tiles (0, 1e-40, 3.38e38) "
                         "equal byte for byte; dequant_scatter idempotent")
            # each route of the scatter's table, on rows the 16-byte body
            # takes (C 2048) and rows it does not (C 130)
            for C in (2048, 130):
                src = rand_rows((64, C), dtype, 7) * 1e-2
                spread = [int(x) for x in rng.permutation(32) * 2]  # distinct, unsorted
                routes = {
                    "sorted distinct rows, a list": (sorted(spread), 1, "starts"),
                    "unsorted distinct rows, a list (the bitmap)": (spread, 1, "starts"),
                    "unsorted distinct rows, an array": (np.array(spread), 1, "starts"),
                    "unsorted disjoint blocks of 2, a list (the numpy route)": (spread[:16], 2, "starts"),
                    "repeated rows, a list": (spread + spread[:5], 1, "param"),
                    "overlapping blocks of 8": (OVERLAP_STARTS[0], 8, "param"),
                }
                for why, (starts, block, want) in routes.items():
                    form = quant_vs_plain(src, starts, block, fmt, rand_rows((64, C), dtype, 8))
                    assert form == want, (why, C, form, want)
            log("quant", f"{fmt} from {str(dtype)[6:]}: equal on every route of the scatter's table, C 2048 and "
                         f"130: " + ", ".join(f"{why} ({want})" for why, (_, _, want) in routes.items()))
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
    # the scatter's table at each form's edge: the by-value capacity of
    # starts and one past it (the device table), and of last-writer segments
    # (each row named twice, rows apart, is one segment of its second tile)
    scap, cap = rp.PARAM_STARTS, rp.PARAM_SEGS
    edges = {
        "by-value capacity of starts": ([int(x) for x in rng.permutation(scap)], "starts"),
        "one past it": ([int(x) for x in rng.permutation(scap + 1)], "starts_device"),
        "by-value capacity of segments": ([2 * i for i in range(cap) for _ in (0, 1)], "param"),
        "one past it, segments": ([2 * i for i in range(cap + 1) for _ in (0, 1)], "device"),
    }
    for why, (starts, want) in edges.items():
        src = rand_rows((2 * cap + 2 if want in ("param", "device") else scap + 1, 128), torch.float32, 9)
        before = rq.launches["dequant_scatter_rows"]
        form = quant_vs_plain(src, starts, 1, "int8", rand_rows(tuple(src.shape), torch.float32, 10))
        assert form == want and rq.launches["dequant_scatter_rows"] == before + 2, (why, form)
    log("quant", "dequant_scatter_rows at its table's edges, one launch each: "
                 + ", ".join(f"{why} ({len(st)} starts, {want})" for why, (st, want) in edges.items()))
    src = rand_rows((16, 8), torch.float32, 0)
    for why, call in {
        "pack_quant_rows start 16": lambda: rq.pack_quant_rows_cuda(src, [16], 1, "int8"),
        "pack_quant_rows int8 source": lambda: rq.pack_quant_rows_cuda(src.to(torch.int8), [0], 1, "int8"),
        "dequant_scatter_rows start -1": lambda: rq.dequant_scatter_rows_cuda(
            src, src[:1].to(torch.int8), torch.ones(1, 1, device="cuda"), [-1], 1),
        "dequant_scatter_rows start 16 as an array": lambda: rq.dequant_scatter_rows_cuda(
            src, src[:1].to(torch.int8), torch.ones(1, 1, device="cuda"), np.array([16]), 1),
        "dequant_scatter_rows a buffer of other tiles": lambda: rq.dequant_scatter_rows_cuda(
            src, src[:2].to(torch.int8), torch.ones(1, 1, device="cuda"), [0], 1),
    }.items():
        before = dict(rq.launches)
        try:
            call()
        except ValueError:
            log("quant", f"refused {why}")
        else:
            raise AssertionError(f"quant kernel accepted {why}")
        assert rq.launches == before, f"a refused call launched: {why}"


QUANT_ROUTES = ("warp", "block", "grid")


def _zero_padded(x: torch.Tensor, C: int) -> torch.Tensor:
    """``x``'s rows padded with zeros on the right to ``C`` columns."""
    return torch.nn.functional.pad(x, (0, C - x.shape[1])).contiguous()


def phase_quant_routes() -> None:
    """pack_quant_rows on each route, byte for byte against its plain
    version, int8 and fp8-e4m3 from f32 and bf16, each call one launch of
    the route :func:`rq.route` picks: tiles on both sides of each boundary
    (one row of C elements, C a multiple of 8 for the 16-byte bodies and
    one past it for the element bodies), with repeated and overlapping
    starts; and the edge tiles (0, 1e-40, 3.38e38), quotients at and next to
    half-integers and a NaN, each row padded with zeros (which leave its
    absmax as it is) to widths that send it to each route, with repeats and
    overlaps; a NaN tile's scale is NaN on every route."""
    for fmt in QUANT_FORMATS:
        for dtype in (torch.float32, torch.bfloat16):
            it = torch.finfo(dtype).bits // 8
            w, b = rq.WARP_BYTES // it, rq.BLOCK_BYTES // it
            seen: dict[str, int] = {}
            for C in (w - 8, w, w + 8, w + 1, b, b + 8, b + 1, b // 8):
                src = rand_rows((10, C), dtype, C) * 1e-3
                for starts, block in (([4, 0, 4, 2, 7], 1), ([0, 1, 3, 6], 2), ([1, 0], 8)):
                    took = pack_vs_plain(src, starts, block, fmt)[-1]
                    seen[took] = seen.get(took, 0) + 1
            assert set(seen) == set(QUANT_ROUTES), seen
            edge = torch.tensor([[0.0] * 130, [1e-40] * 130, [3.38e38] * 130], device="cuda").to(dtype)
            # x / scale at and next to half-integers and to +-qmax +- 0.5
            qmax = R.WIRE_QMAX[fmt]
            ramp = (torch.arange(-127, 129, dtype=torch.float32, device="cuda") + 0.5) * (qmax / 127.0)
            ramp[-2:] = 0.0
            halves = torch.stack([ramp, ramp * (1 + 2**-20), ramp.nextafter(torch.zeros_like(ramp))])
            halves[:, 0] = qmax  # the tile's absmax: scale ~ 1 for int8
            halves = halves.to(dtype)
            nan = rand_rows((2, 136), dtype, 3)
            nan[1, 77] = float("nan")
            # one row's widths on each route: a multiple of 8 (the 16-byte
            # body) and not (the element body)
            widths = {"warp": (128, 130), "block": (w + 8, w + 1), "grid": (b + 8, b + 1)}
            for name, (vec_c, elem_c) in widths.items():
                for C in (vec_c, elem_c):
                    tile = _zero_padded(edge, C)
                    for starts, block in (([0, 1, 2], 1), ([2, 0, 2, 1, 0], 1), ([0, 1, 1], 2)):  # repeats, overlaps
                        took = pack_vs_plain(tile, starts, block, fmt)[-1]
                        assert block > 1 or took == name, (name, C, took)
                assert pack_vs_plain(_zero_padded(halves, max(vec_c, 256)), [0, 1, 2], 1, fmt)[-1] == name
                before = rq.route_launches[name]
                q, sc = rq.pack_quant_rows_cuda(_zero_padded(nan, max(elem_c, 136)), [0, 1], 1, fmt)
                torch.cuda.synchronize()
                assert rq.route_launches[name] == before + 1, name
                assert not sc[0].isnan().any() and sc[1].isnan().all(), (name, sc)
            log("quant", f"pack_quant_rows {fmt} from {str(dtype)[6:]}: equal on the route each tile's size picks "
                         f"({seen} calls, C {w} / {b} elements at the boundaries, 16-byte and element bodies, "
                         f"repeated and overlapping starts), and with the edge tiles, repeats, overlaps and "
                         f"quotients at half-integers zero-padded to widths {widths} (one row on each route); a "
                         "NaN tile's scale is NaN on every route")
    # the grid route on many tiles of a stacked moment (each block's share
    # staged, held and streamed)
    stacked = rand_rows(STACKED_MOMENT, torch.float32, 42) * 1e-3
    for starts in ([27, 3, 17, 3], list(range(28))):
        pack_vs_plain(stacked, starts, 1, "int8")
    del stacked
    torch.cuda.empty_cache()
    log("quant", f"pack_quant_rows equal on the grid route at 4 rows (one repeated) and all 28 rows of "
                 f"{STACKED_MOMENT} f32")


def phase_start_types() -> None:
    """Every row and quant wrapper refuses a float start with the port's
    ValueError, naming it, whatever the form of the starts (the list
    entries read a list in the library), and launches nothing; integer forms
    and the empty list pass."""
    src = rand_rows((16, 8), torch.float32, 0)
    forms = {"a list of one": [1.5], "a list of many": [0, 1.5, 2], "a tuple": (0, 1.5),
             "a float numpy array": np.array([0.0, 1.5]), "a float tensor": torch.tensor([0.0, 1.5])}

    def calls(starts):
        nb = len(starts)
        q8 = torch.zeros((nb, 8), dtype=torch.int8, device="cuda")
        ones = torch.ones((nb, 1), device="cuda")
        return {
            "pack_rows": lambda: rp.pack_rows_cuda(src, starts, 1),
            "unpack_rows": lambda: rp.unpack_rows_cuda(src[:nb], starts, 1, 16),
            "scatter_rows": lambda: rp.scatter_rows_cuda(src.clone(), src[:nb], starts, 1),
            "relayout_rows": lambda: rp.relayout_rows_cuda(src.clone(), src, starts, 1),
            "pack_quant_rows": lambda: rq.pack_quant_rows_cuda(src, starts, 1, "int8"),
            "dequant_scatter_rows": lambda: rq.dequant_scatter_rows_cuda(src.clone(), q8, ones, starts, 1),
        }

    before = (dict(rp.launches), dict(rq.launches))
    for why, starts in forms.items():
        for name, call in calls(starts).items():
            try:
                call()
            except ValueError as e:
                assert "1.5" in str(e), (name, why, e)
            else:
                raise AssertionError(f"{name} accepted a float start in {why}")
    torch.cuda.synchronize()
    assert (rp.launches, rq.launches) == before, "a refused call launched"
    log("starts", f"a float start refused with ValueError naming it, no launch, by {sorted(calls([0]))}, in "
                  f"{', '.join(forms)}")
    for starts in ([], [3], [5, 2], (5, 2), np.array([5, 2]), torch.tensor([5, 2]), [np.int64(5), 2]):
        q, sc = rq.pack_quant_rows_cuda(src, starts, 1, "int8")
        q_r, sc_r = R.pack_quant_rows_ref(src, starts, 1, "int8")
        out = rp.pack_rows_cuda(src, starts, 1)
        torch.cuda.synchronize()
        assert torch.equal(q, q_r) and torch.equal(sc, sc_r) and torch.equal(out, R.pack_rows_ref(src, starts, 1))
    log("starts", "integer starts (a list, a tuple, an int64 array and tensor, numpy ints in a list) and the empty "
                  "list pass through pack_rows and pack_quant_rows, equal to the plain versions")


def _all_counts() -> dict:
    return {"flash_attention": fa.launches, "flash_attention_bwd": fa.bwd_launches,
            "flash_attention_tc": fa.tc_launches, "flash_attention_bwd_tc": fa.tc_bwd_launches,
            **rp.launches, **rq.launches, **{f"pack_quant_rows_{k}": v for k, v in rq.route_launches.items()}}


def _zero_counts() -> None:
    fa.launches = fa.bwd_launches = fa.tc_launches = fa.cc_launches = fa.tc_bwd_launches = fa.cc_bwd_launches = 0
    for counts in (rp.launches, rq.launches, rq.route_launches):
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


def cut_checker(commits: list, controller, rebuild):
    """A ``rebuild_state`` that first holds the state a commit delivered
    against the cut it was moved from, before any update: byte for byte on
    the lossless wire, the plain round trip under the controller's
    quantizing wire policy. Appends one entry to ``commits`` a commit.
    ``controller()`` gives the controller, ``rebuild`` the original."""
    from repro_torch.utils.pytree import tree_paths

    def checked_rebuild(named, params_like, opt_like, extras):
        t0 = time.perf_counter()
        ctrl = controller()
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
        return rebuild(named, params_like, opt_like, extras)

    return checked_rebuild


def phase_train() -> tuple[dict, int, float]:
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

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    C.rebuild_state = cut_checker(commits, lambda: ctrl, orig_rebuild)
    try:
        ctrl = LiveRController(cfg, ParallelConfig(dp=2, tp=2), opt, overlap="stream", wire_policy=WirePolicy(), **kw)
        _zero_counts()  # the training path's counts start here ...
        t_run = time.perf_counter()
        losses = ctrl.train_steps(TRAIN["before"])
        ctrl.request_resize(ParallelConfig(dp=2, tp=4))
        during = 0
        quant_host = {k: [0, 0.0] for k in QUANT_KERNELS}  # calls, wrapper seconds, over the streamed resize
        pack_routes = {k: [0, 0.0, 0] for k in rq.route_launches}  # the same for pack by route, and its starts
        pack_cuda = rq.pack_quant_rows_cuda

        def pack_by_route(src, starts, *args):
            before = dict(rq.route_launches)
            t0 = time.perf_counter()
            out = pack_cuda(src, starts, *args)
            seconds = time.perf_counter() - t0
            took = next(k for k in before if rq.route_launches[k] != before[k])
            pack_routes[took][0] += 1
            pack_routes[took][1] += seconds
            pack_routes[took][2] += len(starts)
            return out

        rq.pack_quant_rows_cuda = pack_by_route
        try:
            with _wrapper_clocks(quant_host, rq, QUANT_KERNELS):
                while not ctrl.records:
                    losses += ctrl.train_steps(1)
                    during += 1
                    assert during < 200, "the streamed resize never committed"
        finally:
            rq.pack_quant_rows_cuda = pack_cuda
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
    log("train", "the streamed resize's quant wrappers on the host clock: "
                 + ", ".join(f"{k} {calls} calls, {1e3 * sec / max(calls, 1):.4f} ms per call, {sec:.4f} s in all"
                             for k, (calls, sec) in quant_host.items())
                 + "; pack_quant_rows by route: "
                 + ", ".join(f"{k} {calls} calls of {starts / max(calls, 1):.0f} starts, "
                             f"{1e3 * sec / max(calls, 1):.4f} ms per call"
                             for k, (calls, sec, starts) in pack_routes.items()))

    # where a step's time goes: one more step on the final world, its two
    # halves (gradients, update) apart, under the profiler
    from torch.profiler import ProfilerActivity, profile

    world = ctrl.world
    batch = {"tokens": torch.from_numpy(ctrl.data.global_batch_at(ctrl.step)).to("cuda", torch.long)}
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        open_trace()
        t0 = time.perf_counter()
        marks[0].record()
        _, _, grads = world.grad_fn(ctrl.params, batch)
        marks[1].record()
        world.update_fn(grads, ctrl.opt_state, ctrl.params)
        marks[2].record()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(TRACE_PAD_S)
    del grads
    busy: dict[str, float] = {}
    by_name: dict[str, float] = {}
    for e in device_events(prof):
        name = e.name
        if any(k in name for k in ("bwd_dkdv", "bwd_dq", "bwd_rowdot")):
            cls = "flash backward"
        elif "fa_fwd" in name:
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
    return launches, len(losses), peak_gb


def check_train_launches(launches: dict, steps: int) -> None:
    """Every kernel of the training path ran on it: the forward twice a
    layer a step (remat reruns it), the backward once, the quant kernels
    in the streamed commit, the row kernels in it too. qwen3 computes in
    bf16 at head dim 128, so every flash launch is on the tensor cores."""
    cfg = get_config(TRAIN["arch"])
    layers = cfg.num_layers
    for name in ("flash_attention", "flash_attention_bwd", "pack_rows", "scatter_rows",
                 "pack_quant_rows", "dequant_scatter_rows"):
        assert launches[name] > 0, f"{name} was not launched on the training path"
    assert launches["flash_attention_bwd"] == layers * steps, launches
    assert launches["flash_attention"] == 2 * layers * steps, launches
    assert fa.route(getattr(torch, cfg.dtype), cfg.resolved_head_dim) == "tensor_cores"
    assert launches["flash_attention_tc"] == launches["flash_attention"], launches
    assert launches["flash_attention_bwd_tc"] == launches["flash_attention_bwd"], launches
    log("train", f"flash launches by route: forward {launches['flash_attention_tc']} tensor_cores / "
                 f"{launches['flash_attention'] - launches['flash_attention_tc']} cuda_cores, backward "
                 f"{launches['flash_attention_bwd_tc']} / "
                 f"{launches['flash_attention_bwd'] - launches['flash_attention_bwd_tc']}")
    assert launches["pack_quant_rows"] == launches["dequant_scatter_rows"]
    # the embedding's and norms' moment rows are small tiles, the stacked
    # layers' rows large ones
    assert launches["pack_quant_rows_warp"] > 0 and launches["pack_quant_rows_grid"] > 0, launches
    assert sum(launches[f"pack_quant_rows_{k}"] for k in rq.route_launches) == launches["pack_quant_rows"]
    assert launches["pack_rows"] == launches["scatter_rows"]


# the lifecycle phase: qwen3-1.7b as in TRAIN, lossless; stream_k 8 makes a
# stream of its 29 layers (28 blocks and the embedding's) take 4 rounds
LIFECYCLE = dict(stream_k=8, before=2, after=2)
TOL_PEAK = 1.05  # the lifecycle's peak memory against the train phase's


def phase_lifecycle(train_peak_gb: float) -> dict:
    """The controller's lifecycle around the commit at full width (see the
    module docstring, 14): the warm pool with a speculative prefetch, a
    mid-stream retarget that adopts the streamed state, and a deadline
    escalation to a byte-moving stop-copy, against a control run never
    resized. Returns the launches of the path."""
    from repro_torch.core import controller as C
    from repro_torch.core.controller import LiveRController
    from repro_torch.core.topology_search import likely_next_targets
    from repro_torch.core.world_pool import WorldPool
    from repro_torch.optim import AdamWConfig
    from repro_torch.reshard import OverlapSession
    from repro_torch.reshard.overlap import shares_storage

    cfg = get_config(TRAIN["arch"])
    opt = AdamWConfig(learning_rate=1e-4, warmup_steps=2, total_steps=1000)
    kw = dict(seq_len=TRAIN["seq"], global_batch=TRAIN["batch"], device=TRAIN["device"])
    SRC, T1, T = ParallelConfig(dp=2, tp=2), ParallelConfig(dp=2, tp=4), ParallelConfig(dp=1, tp=4)
    log("lifecycle", f"likely next targets of {SRC.describe()} (max world 8, batch {TRAIN['batch']} x "
                     f"{TRAIN['seq']}, no pipeline; H100 constants, for information): "
                     + ", ".join(p.describe() for p in likely_next_targets(
                         cfg, SRC, max_world=8, global_batch=TRAIN["batch"], seq_len=TRAIN["seq"], max_pp=1)))
    commits: list[dict] = []
    adoptions: list[dict] = []
    orig_rebuild, orig_adopt = C.rebuild_state, OverlapSession.adopt

    def adopt(session, carries, streamed_at, live):
        """The adoption's outcome, by tensor ids (holding the tensors here
        would keep the old state alive past the commit)."""
        n = orig_adopt(session, carries, streamed_at, live)
        live = list(live.values())
        adoptions.append({"reused": n, "carries": {k: id(t) for k, t in carries.items()},
                          "kept": [k for k, t in carries.items() if session.executor.dst.get(k) is t],
                          "aliasing": [k for k, t in carries.items() if shares_storage(t, live)]})
        return n

    def prepared(what: str) -> dict:
        """Wait for the in-flight Prepare; its timings."""
        ctrl.wait_shadow_ready()
        t = dict(ctrl._builder.result().timings)
        prepares[what] = t
        return t

    def train_until(done, limit: int = 60) -> None:
        while not done():
            losses.extend(ctrl.train_steps(1))
            assert len(losses) < limit, "the lifecycle never got there"

    prepares: dict[str, dict] = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    C.rebuild_state = cut_checker(commits, lambda: ctrl, orig_rebuild)
    OverlapSession.adopt = adopt
    try:
        ctrl = LiveRController(cfg, SRC, opt, overlap="stream", stream_k=LIFECYCLE["stream_k"],
                               world_pool=WorldPool(capacity=2), **kw)
        _zero_counts()  # the lifecycle path's counts start here ...
        t_run = time.perf_counter()
        losses = ctrl.train_steps(LIFECYCLE["before"])
        # a speculative build of T beside a real resize to T1
        assert ctrl.prefetch_world(T), "the prefetch did not start"
        ctrl.request_resize(T1)
        assert "prepare_source" not in prepared("cold"), prepares["cold"]  # a full build
        train_until(lambda: ctrl._session is not None and ctrl._session.report.precopy_rounds >= 1)
        old_carries = {k: id(t) for k, t in ctrl._session.executor.dst.items()}
        # T supersedes T1 mid-stream
        ctrl.retarget_resize(T)
        retargeted = ctrl.records[-1]
        assert retargeted.outcome == "retargeted" and retargeted.dst == T1.describe(), retargeted
        source = prepared("retarget")["prepare_source"]
        assert source in ("speculative_join", "pool"), prepares["retarget"]
        train_until(lambda: len(ctrl.records) == 2)
        rec_t = ctrl.records[-1]
        assert rec_t.outcome == "committed" and rec_t.dst == T.describe(), rec_t
        assert rec_t.prepare_source == source and rec_t.reused_layers >= 1, rec_t
        # every carry of the superseded session was handed on and adopted as
        # the same tensor, and none aliases a live one
        [a] = adoptions
        assert a["reused"] >= 1 and a["carries"] == old_carries, a
        assert sorted(a["kept"]) == sorted(old_carries) and not a["aliasing"], a
        # back to the retired source world, warm; escalated after one round
        ctrl.request_resize(SRC)
        prepared("warm")
        train_until(lambda: ctrl._session is not None and ctrl._session.report.precopy_rounds >= 1)
        escalated = ctrl.escalate_commit()
        assert escalated is ctrl.records[-1] and escalated.outcome == "fell_back", escalated
        assert escalated.warm_hit and escalated.prepare_source == "pool", escalated
        assert escalated.executed_bytes > 0 and escalated.precopy_bytes > 0, escalated
        assert ctrl.world.parallel == SRC and not ctrl.reconfig_pending
        losses += ctrl.train_steps(LIFECYCLE["after"])
        run_s = time.perf_counter() - t_run
        launches = _all_counts()  # ... and are read here
    finally:
        C.rebuild_state, OverlapSession.adopt = orig_rebuild, orig_adopt
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    pool = ctrl.world_pool.stats.to_dict()
    assert [r.outcome for r in ctrl.records] == ["retargeted", "committed", "fell_back"], ctrl.records
    assert len(commits) == 2 and all(not c["quantized"] for c in commits)
    streamed, stop = (ctrl.records[1], commits[0]), (ctrl.records[2], commits[1])
    log("lifecycle", f"{cfg.name} full width, batch {TRAIN['batch']} x {TRAIN['seq']}, lossless wire, stream_k "
                     f"{LIFECYCLE['stream_k']}, WorldPool(capacity=2): {SRC.describe()} -> {T1.describe()} "
                     f"(retargeted after {retargeted.precopy_bytes / 1e9:.4f} GB of pre-copy) -> {T.describe()} "
                     f"(prepare_source {rec_t.prepare_source}, reused layers {rec_t.reused_layers}) -> "
                     f"{SRC.describe()} (warm, escalated): {len(losses)} steps in {run_s:.1f}s, peak memory "
                     f"{peak_gb:.2f} GB (train phase {train_peak_gb:.2f} GB), pool {pool}, launches {launches}")
    for what, t in prepares.items():
        log("lifecycle", f"{what} Prepare: prepare_s {t['prepare_total_s']:.4f} (warm_s {t.get('warm_s', 0.0):.4f}, "
                         f"refresh_s {t.get('refresh_s', 0.0):.4f}, plan_s {t['plan_s']:.4f}, orphan_wait_s "
                         f"{t['orphan_wait_s']:.4f}, alloc_s {t['alloc_s']:.4f}), source "
                         f"{t.get('prepare_source', 'cold')}")
    rec, c = streamed
    log("lifecycle", f"streamed commit {rec.src} -> {rec.dst} at step {c['step']}: pause_s "
                     f"{rec.total_pause_s - c['check_s']:.4f}, executed {rec.executed_bytes / 1e9:.4f} GB, "
                     f"dirty layers {rec.dirty_layers}/{rec.layers_total}, {len(c['adopted'])} tensors adopted")
    rec, c = stop
    transfer_s = rec.transfer_s - c["check_s"]
    log("lifecycle", f"escalated stop-copy {rec.src} -> {rec.dst} at step {c['step']}: pause_s "
                     f"{rec.total_pause_s - c['check_s']:.4f}, transfer_s {transfer_s:.4f}, executed "
                     f"{rec.executed_bytes / 1e9:.4f} GB ({rec.executed_bytes / transfer_s / 1e9:.1f} GB/s), "
                     f"pre-copy wasted {rec.precopy_bytes / 1e9:.4f} GB, {len(c['adopted'])} tensors adopted")
    assert all(np.isfinite(losses)), "a loss is not finite"
    assert peak_gb <= TOL_PEAK * train_peak_gb, f"peak {peak_gb:.2f} GB: a second set of destination tensors?"
    del ctrl
    torch.cuda.empty_cache()
    control = LiveRController(cfg, SRC, opt, **kw)
    c_losses = control.train_steps(len(losses))
    log("lifecycle", f"losses {[round(x, 4) for x in losses]}; bitwise equal to the control run never resized: "
                     f"{c_losses == losses}")
    assert c_losses == losses, "the lifecycle's losses differ from the control run's"
    del control
    torch.cuda.empty_cache()
    check_lifecycle_launches(launches, len(losses))
    return launches


def check_lifecycle_launches(launches: dict, steps: int) -> None:
    """The lifecycle path's kernels: flash forward and backward every step,
    the row kernels in each byte-moving commit and round, relayout_rows on
    its equal-size resizes, no quant kernel on the lossless wire."""
    layers = get_config(TRAIN["arch"]).num_layers
    assert launches["flash_attention"] == 2 * layers * steps, launches
    assert launches["flash_attention_bwd"] == layers * steps, launches
    for name in ("pack_rows", "scatter_rows", "relayout_rows"):
        assert launches[name] > 0, f"{name} was not launched on the lifecycle path"
    assert launches["pack_rows"] == launches["scatter_rows"]
    assert launches["pack_quant_rows"] == launches["dequant_scatter_rows"] == 0, launches


def _record(name, source, replaces, launches, err, ms, plain_ms, bound_ms, bound_by, library_ms, **extra) -> dict:
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": launches,
            "max_abs_err": err, "max_err": err, "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms, **extra}


def phase_bwd_times(launches: int, case_err: float) -> dict:
    """The backward kernel at the training shape (bf16), beside the
    CUDA-core route, the plain version's backward and
    ``scaled_dot_product_attention``'s backward, each timed alone on graphs
    kept for reuse."""
    b, s, t, h, kh, d, causal, window = TRAIN_SHAPE
    q, k, v = rand_qkv(TRAIN_SHAPE, torch.bfloat16, seed=7)
    dout = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(8), device="cuda").to(q.dtype)
    kw = dict(causal=causal, window=window)
    out, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
    kernel_ms = median_ms(lambda: fa.flash_attention_bwd_cuda(q, k, v, out, lse, dout, **kw), reps=20)
    on_device_ms = device_ms(lambda: fa.flash_attention_bwd_cuda(q, k, v, out, lse, dout, **kw), "bwd_",
                             per_call=lambda: fa.bwd_launches)
    cuda_cores_ms = median_ms(lambda: fa.flash_attention_bwd_cuda(q, k, v, out, lse, dout, route="cuda_cores", **kw),
                              reps=5, warmup=1)
    qr, kr, vr = (x.clone().requires_grad_(True) for x in (q, k, v))
    plain_out = flash_attention_ref(qr, kr, vr, **kw)
    plain_ms = median_ms(lambda: torch.autograd.grad(plain_out, (qr, kr, vr), dout, retain_graph=True), reps=20)
    ql, kl, vl = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    lib_out = torch.nn.functional.scaled_dot_product_attention(ql, kl, vl, is_causal=causal, enable_gqa=True)
    library = lambda: torch.autograd.grad(lib_out, (ql, kl, vl), dout.transpose(1, 2), retain_graph=True)  # noqa: E731
    library_ms = median_ms(library, reps=20)
    library_device_ms = device_ms(library, "", per_call=True)
    # the least work: S again, dP, dV, dK, dQ (5 products of 2d FLOPs per
    # attended pair); q, k, v, o, dout and lse read, dq, dk, dv written
    flops = 10 * d * b * h * attended_pairs(s, t, causal, window)
    nbytes = sum(x.numel() * x.element_size() for x in (q, k, v, out, dout, lse, q, k, v))
    bytes_ms, flops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOP_PER_S * 1e3
    bound_ms = max(bytes_ms, flops_ms)
    tflops = flops / kernel_ms / 1e9  # the 5 products' FLOPs: the kernel does 7
    log("times", f"flash_attention backward {TRAIN_SHAPE} bf16: kernel {kernel_ms:.4f} ms ({tflops:.1f} TFLOP/s of "
                 f"the 5 products; its three kernels on the device {on_device_ms:.4f} ms), the CUDA-core route "
                 f"{cuda_cores_ms:.4f} ms, plain backward {plain_ms:.4f} ms, sdpa backward {library_ms:.4f} ms "
                 f"(on the device {library_device_ms:.4f} ms), bound {bound_ms:.4f} ms "
                 f"({nbytes / 1e6:.1f} MB -> {bytes_ms:.4f} ms; {flops / 1e9:.2f} GFLOP -> {flops_ms:.4f} ms)")
    return _record("flash_attention_bwd", "src/repro_torch/kernels/csrc/flash_attention_bwd_tc.cu",
                   "src/repro/kernels/flash_attention.py:124 (backward; the TPU kernel has none)", launches,
                   case_err, kernel_ms, plain_ms, bound_ms, "bytes" if bytes_ms >= flops_ms else "operations",
                   library_ms, device_ms=on_device_ms, library_device_ms=library_device_ms, tflops=tflops,
                   cuda_cores_ms=cuda_cores_ms,
                   sources={"tensor_cores": "src/repro_torch/kernels/csrc/flash_attention_bwd_tc.cu",
                            "cuda_cores": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"},
                   shape=list(TRAIN_SHAPE),
                   err_is="max |error| / max |plain gradient| over the cases, bf16, both routes")


def phase_quant_times(launches: dict) -> list[dict]:
    """The two quant kernels (fp32 <-> int8) at the training path's
    per-layer move (one layer row of a stacked moment: pack_quant_rows'
    grid route) and at 4096 scattered
    embedding-moment rows (the warp route), and pack_quant_rows at 128 tiles
    of 24 embedding rows (192 KB each: the block route, a synthetic case, as
    no path sends tiles of that size): the call (CUDA
    events, median of 20) and the kernels alone on the device (the
    profiler), beside the plain versions and the HBM bound. No single
    PyTorch call computes a per-tile absmax-scaled quantization, so there
    is no library time. Starts rotate between calls so that the inputs are
    not left in the 50 MB L2 cache."""
    rng = np.random.default_rng(11)
    cases = {
        "stacked_row": (STACKED_MOMENT, 1, [[i] for i in range(STACKED_MOMENT[0])]),
        "embed_4096": (EMBED, 1, [[int(x) for x in np.random.default_rng(s).permutation(EMBED[0])[:4096]]
                                  for s in range(8)]),
        "block_tiles": (EMBED, 24, [[24 * int(x) for x in rng.permutation(EMBED[0] // 24)[:128]] for _ in range(8)]),
    }
    recs, by_route = {}, {}
    for case, (shape, block, start_sets) in cases.items():
        rows, C = shape
        src = rand_rows(shape, torch.float32, 31) * 1e-3
        dst = torch.zeros(shape, dtype=torch.float32, device="cuda")
        nb = len(start_sets[0])
        turn = [0]

        def nxt():
            turn[0] += 1
            return start_sets[turn[0] % len(start_sets)]

        natural = rq.route(block * C, 4)
        q, sc, q_r, sc_r, _ = pack_vs_plain(src, start_sets[0], block, "int8")
        a = rq.dequant_scatter_rows_cuda(dst.clone(), q, sc, start_sets[0], block)
        b = R.dequant_scatter_rows_ref(dst.clone(), q, sc, start_sets[0], block)
        err_deq = (a - b).abs().max().item()
        del a, b, q_r, sc_r
        shape_is = f"{nb} tiles of {block} x {C} f32 of {rows} rows <-> int8"
        pack_bytes = nb * block * C * (4 + 1) + nb * 4 + nb * 8
        timed = {("pack_quant_rows", natural): (
            lambda: rq.pack_quant_rows_cuda(src, nxt(), block, "int8"),
            lambda: R.pack_quant_rows_ref(src, nxt(), block, "int8"), pack_bytes, "pack_quant_")}
        if case != "block_tiles":
            timed[("dequant_scatter_rows", None)] = (
                lambda: rq.dequant_scatter_rows_cuda(dst, q, sc, nxt(), block),
                lambda: R.dequant_scatter_rows_ref(dst, q, sc, nxt(), block), pack_bytes, "dequant_scatter_kernel")
        for (kind, name), (kernel, plain, nbytes, kname) in timed.items():
            before = dict(rq.table_launches)
            kernel_ms = median_ms(kernel, reps=20)
            form = "/".join(_quant_forms_since(before)) or rp.table_form(nb, starts=True)
            plain_ms = median_ms(plain, reps=20)
            on_device_ms = device_ms(kernel, kname, per_call=lambda: rq.launches[kind])
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
            err = err_deq if kind == "dequant_scatter_rows" else 0.0  # pack_vs_plain asserted equal bytes
            log("times", f"{kind} {case}{'' if name is None else f' route {name}'} ({shape_is}): call "
                         f"{kernel_ms:.4f} ms (kernels on the device {on_device_ms:.4f} ms, host "
                         f"{kernel_ms - on_device_ms:.4f} ms, table {form}), plain {plain_ms:.4f} ms, library none, "
                         f"bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB), max_abs_err {err:g}")
            assert err == 0.0, f"{kind} disagrees with its plain version at {case}"
            if kind == "pack_quant_rows":
                by_route[name] = dict(
                    case=case, ms=kernel_ms, device_ms=on_device_ms, host_ms=kernel_ms - on_device_ms,
                    plain_ms=plain_ms, bound_ms=bound_ms, shape=shape_is)
            if case == "stacked_row":
                recs[kind] = _record(kind, "src/repro_torch/kernels/csrc/reshard_quant.cu", {
                    "pack_quant_rows": "src/repro/kernels/reshard_quant.py:137",
                    "dequant_scatter_rows": "src/repro/kernels/reshard_quant.py:189"}[kind],
                    launches[kind], err, kernel_ms, plain_ms, bound_ms, "bytes", None,
                    device_ms=on_device_ms, host_ms=kernel_ms - on_device_ms, table=form, shape=shape_is)
        if case == "stacked_row":
            # the rate at which a reduction reads a 50 MB row here: what the
            # grid route's read before its barrier can reach
            read_ms = device_ms(lambda: src[nxt()[0]].amax(), "", per_call=True)
            recs["pack_quant_rows"]["read_yardstick_ms"] = read_ms
            log("times", f"torch.amax of one stacked row on the device (a read of {C * 4 / 1e6:.1f} MB): "
                         f"{read_ms:.4f} ms, {C * 4 / read_ms / 1e9:.2f} TB/s")
        del src, dst, q, sc
        torch.cuda.empty_cache()
    recs["pack_quant_rows"]["routes"] = by_route
    return [recs["pack_quant_rows"], recs["dequant_scatter_rows"]]


# ---------------------------------------------------------------------------
# Slice 4: the SSD and RMSNorm kernels, serving mamba2-2.7b
# ---------------------------------------------------------------------------

# (b, s, h, p, n, chunk): the JAX package's test_ssd_intra_chunk_sweep,
# reduced mamba2's chunk and state, and the serving shape (8 x 512 tokens,
# 80 heads of 64, state 128, chunk 64)
SSD_CASES = [
    (1, 64, 2, 16, 32, 16),
    (2, 128, 3, 32, 64, 32),
    (1, 96, 4, 64, 128, 16),
    (2, 40, 2, 64, 16, 8),
]
SSD_SERVE_SHAPE = (8, 512, 80, 64, 128, 64)
# relative to the largest |y| and |S| of the plain version: f32 sums over a
# chunk in another order
SSD_TOL = 2e-5
# RMSNorm: f32 within 1e-6 (relative above 1: a few f32 ulps of values up
# to ~16, the mean taken in another order); bf16 within one bf16 step
RMS_TOL = 1e-6
RMS_TIME_SHAPE = (4096, 2560)


def ssd_inputs(case, dtype, seed):
    """x, dt (post-softplus range), A, B, C and the within-chunk cumsum of
    dt*A, as ``ops.ssd_scan`` forms it, on the card."""
    b, s, h, p, n, chunk = case
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(b, s, h, p, generator=g, device="cuda").to(dtype)
    dt = torch.rand(b, s, h, generator=g, device="cuda") * 0.29 + 0.01
    A = -(torch.rand(h, generator=g, device="cuda") * 1.5 + 0.5)
    B = torch.randn(b, s, n, generator=g, device="cuda")
    C = torch.randn(b, s, n, generator=g, device="cuda")
    cum = torch.cumsum(dt.reshape(b, s // chunk, chunk, h) * A, dim=2).reshape(b, s, h)
    return x, dt, A, B, C, cum


def ssd_kernel_vs_plain(x, dt, cum, B, C, chunk) -> float:
    """The kernel against the plain block on the same inputs: the larger of
    max|dy| / max|y| and max|dS| / max|S|."""
    y, S = ssd_k.ssd_intra_chunk_cuda(x, dt, cum, B, C, chunk)
    wy, wS = R.ssd_intra_chunk_ref(x, dt, cum, B, C, chunk)
    torch.cuda.synchronize()
    assert y.shape == wy.shape and S.shape == wS.shape and y.dtype == S.dtype == torch.float32
    assert torch.isfinite(y).all() and torch.isfinite(S).all(), "SSD kernel output not finite"
    return max((y - wy).abs().max().item() / wy.abs().max().item(),
               (S - wS).abs().max().item() / wS.abs().max().item())


def phase_ssd_cases() -> float:
    """The SSD kernel against its plain version, TF32 off for the plain
    version's products; a ragged sequence through ``ops.ssd_scan`` (padded
    with dt = 0) against the plain scan; a gradient through the card's scan
    raises. Returns the worst error at the serving shape."""
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for i, case in enumerate(SSD_CASES + [SSD_SERVE_SHAPE]):
            x, dt, A, B, C, cum = ssd_inputs(case, dtype, seed=200 + i)
            err = ssd_kernel_vs_plain(x, dt, cum, B, C, case[-1])
            log("ssd", f"ssd_intra_chunk {case} x {str(dtype)[6:]}: max |error| / max |plain| {err:.3e} over y "
                       f"and S (tol {SSD_TOL:g})")
            assert err <= SSD_TOL, f"SSD kernel disagrees with its plain version on {case}"
            if case == SSD_SERVE_SHAPE:
                worst = max(worst, err)
    for case, s in [((2, 128, 3, 32, 64, 32), 100), ((1, 512, 80, 64, 128, 64), 300)]:
        x, dt, A, B, C, _ = ssd_inputs(case, torch.bfloat16, seed=s)
        x, dt, B, C = x[:, :s], dt[:, :s], B[:, :s], C[:, :s]
        h0 = torch.randn(case[0], case[2], case[3], case[4], device="cuda")
        before = ssd_k.launches
        y, final = ops.ssd_scan(x, dt, A, B, C, case[-1], init_state=h0)
        pad = (-s) % case[-1]
        padded = [torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in (x, dt, B, C)]
        wy, wf = R.ssd_scan_ref(padded[0], padded[1], A, padded[2], padded[3], case[-1], h0)
        torch.cuda.synchronize()
        assert ssd_k.launches == before + 1 and y.shape == x.shape
        err = max((y - wy[:, :s]).abs().max().item() / wy.abs().max().item(),
                  (final - wf).abs().max().item() / wf.abs().max().item())
        log("ssd", f"ops.ssd_scan, ragged s {s} of chunk {case[-1]}, x bf16, nonzero initial state: max |error| / "
                   f"max |plain| {err:.3e} over y and the final state (tol {SSD_TOL:g})")
        assert err <= SSD_TOL, f"ops.ssd_scan disagrees with the plain scan at s={s}"
    x, dt, A, B, C, _ = ssd_inputs(SSD_CASES[0], torch.float32, seed=1)
    xg = x.clone().requires_grad_(True)
    try:
        ops.ssd_scan(xg, dt, A, B, C, SSD_CASES[0][-1])[0].sum().backward()
    except NotImplementedError as e:
        assert "ROADMAP" in str(e)
        log("ssd", f"a gradient through the card's scan raises: {e}")
    else:
        raise AssertionError("a gradient through the card's SSD scan did not raise")
    for why, call in {
        "a sequence not a multiple of the chunk": lambda: ssd_k.ssd_intra_chunk_cuda(
            x[:, :60].contiguous(), dt[:, :60].contiguous(), dt[:, :60].contiguous(), B[:, :60].contiguous(),
            C[:, :60].contiguous(), 16),
        "chunk 128": lambda: ssd_k.ssd_intra_chunk_cuda(x, dt, dt, B, C, 128),
    }.items():
        try:
            call()
        except ValueError:
            log("ssd", f"refused {why}")
        else:
            raise AssertionError(f"SSD kernel accepted {why}")
    return worst


def _rms_two_reads(x: torch.Tensor, sc: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The kernel's two-read body on any row, through the library's entry
    (nv = 0), as the wrapper launches it for rows the register body does not
    take; not counted."""
    out = torch.empty_like(x)
    d = x.shape[-1]
    codes = rms_k._DTYPE_CODES
    err = rms_k._lib().repro_rmsnorm(x.data_ptr(), sc.data_ptr(), out.data_ptr(), x.numel() // d, d,
                                     codes[x.dtype], codes[sc.dtype], eps, 0,
                                     torch.cuda.current_stream().cuda_stream)
    assert err == 0, err
    return out


def phase_rms_cases() -> float:
    """The RMSNorm kernel against its plain version, both bodies: the
    register body (aligned rows up to its cap) and the two-read body (a d
    above the cap, an odd d, a misaligned row); on aligned rows the register
    body's bits against the two-read body's. Returns the worst max |error|
    in bf16."""
    worst = 0.0
    rng = np.random.default_rng(5)
    rows_list = [1, 37, 300] + [int(r) for r in rng.integers(2, 300, 2)]
    dims = (128, 256, 2048, 2560, 2561, 6400)
    for dtype in (torch.float32, torch.bfloat16):
        n, err_max, units, bodies, same = 0, 0.0, 0.0, {}, 0
        for d in dims:
            for rows in rows_list:
                g = torch.Generator(device="cuda").manual_seed(rows * d)
                x = torch.randn(rows, d, generator=g, device="cuda").to(dtype)
                sc = torch.randn(d, generator=g, device="cuda").to(dtype)
                if d == 2048 and rows == 37:  # a misaligned row: x one element past 16 bytes
                    x = torch.cat([x.new_zeros(1), x.reshape(-1)])[1:].view(rows, d)
                before = dict(rms_k.body_launches)
                got, want = rms_k.rmsnorm_cuda(x, sc), R.rmsnorm_ref(x, sc)
                torch.cuda.synchronize()
                (which,) = [k for k in before if rms_k.body_launches[k] != before[k]]
                nv = rms_k.body(d, x.element_size(), x.data_ptr() % 16 == 0 and got.data_ptr() % 16 == 0)
                assert which == ("registers" if nv else "two_reads") and sum(rms_k.body_launches.values()) == sum(
                    before.values()) + 1, (d, rows, which)
                bodies.setdefault(which, set()).add(d)
                assert got.dtype == dtype and got.shape == x.shape
                if which == "registers":  # the same bits as the two-read body
                    assert torch.equal(_bytes(got), _bytes(_rms_two_reads(x, sc))), (d, rows, dtype)
                    same += 1
                diff = (got.float() - want.float()).abs()
                if dtype == torch.float32:
                    allowed = RMS_TOL * want.abs().clamp_min(1.0)
                else:  # one bf16 step at the value's magnitude
                    allowed = torch.exp2(torch.floor(torch.log2(want.float().abs().clamp_min(2.0**-126))) - 7)
                units = max(units, (diff / allowed).max().item())
                err_max = max(err_max, diff.max().item())
                n += 1
        log("rms", f"rmsnorm {str(dtype)[6:]}: {n} cases (rows {rows_list}, d {'/'.join(map(str, dims))}; "
                   f"bodies by d {({k: sorted(v) for k, v in bodies.items()})}): max |error| {err_max:.3e}, "
                   f"{units:.3f} of the tolerance "
                   f"({'1e-6, relative above 1' if dtype == torch.float32 else 'one bf16 step'}); the register "
                   f"body equal bit for bit to the two-read body in {same} cases")
        assert units <= 1.0, f"RMSNorm kernel disagrees with its plain version in {dtype}"
        assert set(bodies) == {"registers", "two_reads"}, bodies
        if dtype == torch.bfloat16:
            worst = max(worst, err_max)
    try:
        rms_k.rmsnorm_cuda(torch.zeros(4, 8, device="cuda"), torch.ones(16, device="cuda"))
    except ValueError:
        log("rms", "refused a scale of the wrong width")
    else:
        raise AssertionError("RMSNorm kernel accepted a scale of the wrong width")
    return worst


def phase_serve_ssm() -> tuple[int, float]:
    """mamba2-2.7b at full width through ``serve_once``; see the module
    docstring, 19."""
    cfg = get_config("mamba2-2.7b")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = ssd_k.launches = 0  # the main path's counts start here
    out = serve_once(cfg, device="cuda", seed=0, **SERVE)
    launches, flash = ssd_k.launches, fa.launches  # ... and are read here
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    toks = out["tokens"]
    tok_s = SERVE["batch"] * SERVE["gen"] / out["decode_s"]
    log("serve-ssm", f"{cfg.name} full width ({cfg.num_layers} SSD layers, d_model {cfg.d_model}, "
                     f"{cfg.ssm_expand * cfg.d_model // 64} heads of 64, state {cfg.ssm_state}, chunk {cfg.ssm_chunk}, "
                     f"{cfg.param_count()} params), batch {SERVE['batch']} x prompt {SERVE['prompt_len']}, "
                     f"{SERVE['gen']} greedy tokens: prefill_s {out['prefill_s']:.4f}, decode_s {out['decode_s']:.4f} "
                     f"({tok_s:.1f} tok/s), peak memory {peak_gb:.2f} GB, SSD launches {launches}")
    assert launches == cfg.num_layers and flash == 0, f"{launches} SSD launches, want {cfg.num_layers}"
    assert toks.shape == (SERVE["batch"], SERVE["gen"] + 1), toks.shape
    assert toks.min() >= 0 and toks.max() < cfg.vocab_size

    # second run: same tokens; capture the kernel's inputs in the first and
    # last layer
    captured, calls, orig = {}, [0], ssd_k.ssd_intra_chunk

    def capture(x, dt, cum, B, C, chunk):
        i = calls[0]
        calls[0] += 1
        if i in (0, cfg.num_layers - 1):
            captured[i] = (x.clone(), dt.clone(), cum.clone(), B.clone(), C.clone(), chunk)
        return orig(x, dt, cum, B, C, chunk)

    ssd_k.ssd_intra_chunk = capture
    try:
        again = serve_once(cfg, device="cuda", seed=0, **SERVE)
    finally:
        ssd_k.ssd_intra_chunk = orig
    assert (again["tokens"] == toks).all(), "a second run gave other tokens"
    log("serve-ssm", f"second run: identical tokens; prefill_s {again['prefill_s']:.4f}, decode "
                     f"{SERVE['batch'] * SERVE['gen'] / again['decode_s']:.1f} tok/s")
    worst = 0.0
    for i, args in sorted(captured.items()):
        err = ssd_kernel_vs_plain(*args)
        log("serve-ssm", f"layer {i} SSD block x {tuple(args[0].shape)} {str(args[0].dtype)[6:]}: kernel vs plain "
                         f"max |error| / max |plain| {err:.3e} (tol {SSD_TOL:g})")
        assert err <= SSD_TOL
        worst = max(worst, err)
    del captured

    params = M.cast_params(
        M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda"), cfg.dtype
    )
    with torch.inference_mode():
        logits, cache, _ = M.prefill(cfg, params, demo_batch(cfg, SERVE["batch"], SERVE["prompt_len"]),
                                     max_seq=SERVE["prompt_len"] + 4)
    assert logits.shape == (SERVE["batch"], 1, cfg.vocab_size)
    assert torch.isfinite(logits.float()).all(), "full-width logits not finite"
    assert all(torch.isfinite(c).all() for c in cache["pos0"].values()), "the SSD cache is not finite"
    assert (logits[:, -1].argmax(-1).cpu().numpy() == toks[:, 0]).all()
    log("serve-ssm", f"full-width prefill logits {tuple(logits.shape)} finite, ssd/conv cache "
                     f"{[tuple(c.shape) for c in cache['pos0'].values()]} finite; first tokens match")
    phase_profile(cfg, params, logits, cache)
    del params, logits, cache
    torch.cuda.empty_cache()
    return launches, worst


def ssd_tensor_core_flops(case, x_dtype) -> int:
    """The TF32 tensor-core FLOPs the SSD kernel issues (mma.sync m16n8k8, 2048
    FLOPs each): C.B^T once a block in 3 products (4 x 8 tiles, 16 k-steps);
    a head's y = M.x over the k-steps at or below the diagonal (20 of the 32
    k-step rows of its 4 m-tiles, 8 n-tiles) and S = x^T.(w o B) (4 x 16
    tiles, 8 k-steps), each in 3 products, or 2 for a bf16 x (exact in TF32).
    A block takes a group of heads, as many groups as one wave of two blocks
    an SM holds (csrc/ssd_scan.cu)."""
    b, s, h, p, n, chunk = case
    bcs = b * (s // chunk)
    groups = min(h, max(1, 2 * torch.cuda.get_device_properties(0).multi_processor_count // bcs))
    groups = -(-h // -(-h // groups))
    per_head = (20 * 8 + 4 * 16 * 8) * (2 if x_dtype == torch.bfloat16 else 3)
    return 2048 * (bcs * groups * 4 * 8 * 16 * 3 + bcs * h * per_head)


def phase_ssd_times(launches: int, err: float) -> dict:
    """The SSD kernel at the serving shape (x bf16) beside its plain
    version, and the card's bounds: the bytes, the f32 products on the CUDA
    cores, and the tensor-core products the kernel issues. No single PyTorch
    call computes it."""
    b, s, h, p, n, chunk = SSD_SERVE_SHAPE
    x, dt, A, B, C, cum = ssd_inputs(SSD_SERVE_SHAPE, torch.bfloat16, seed=99)
    case_err = ssd_kernel_vs_plain(x, dt, cum, B, C, chunk)
    kernel_ms = median_ms(lambda: ssd_k.ssd_intra_chunk_cuda(x, dt, cum, B, C, chunk))
    on_device_ms = device_ms(lambda: ssd_k.ssd_intra_chunk_cuda(x, dt, cum, B, C, chunk), "ssd_intra_chunk")
    plain_ms = median_ms(lambda: R.ssd_intra_chunk_ref(x, dt, cum, B, C, chunk))
    nc = s // chunk
    # each input read once, each output written once
    nbytes = sum(t.numel() * t.element_size() for t in (x, dt, cum, B, C)) + 4 * (b * s * h * p + b * nc * h * p * n)
    # the least f32 work: C.B^T and M.x over the causal half of each chunk
    # (C.B^T once per batch row and chunk), and the chunk state over all of it
    pairs = chunk * (chunk + 1) // 2
    flops = b * nc * (2 * n * pairs + h * (2 * p * pairs + 2 * chunk * p * n))
    tc_flops = ssd_tensor_core_flops(SSD_SERVE_SHAPE, x.dtype)
    bytes_ms, flops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
    tc_ms = tc_flops / TF32_FLOP_PER_S * 1e3
    # the products run on the tensor cores: the least time is the larger of
    # the bytes and the tensor-core products; the CUDA cores' f32 bound is
    # reported beside it
    bound_ms = max(bytes_ms, tc_ms)
    log("times", f"ssd_intra_chunk {SSD_SERVE_SHAPE} x bf16: kernel {kernel_ms:.4f} ms (on the device "
                 f"{on_device_ms:.4f} ms), plain {plain_ms:.4f} ms, library none, bound {bound_ms:.4f} ms "
                 f"({nbytes / 1e6:.1f} MB -> {bytes_ms:.4f} ms; the tensor-core products it issues "
                 f"{tc_flops / 1e9:.2f} GFLOP TF32 -> {tc_ms:.4f} ms; the f32 products "
                 f"{flops / 1e9:.2f} GFLOP on the CUDA cores -> {flops_ms:.4f} ms), "
                 f"max |error| / max |plain| {case_err:.3e}")
    assert case_err <= SSD_TOL
    return _record("ssd_intra_chunk", "src/repro_torch/kernels/csrc/ssd_scan.cu", "src/repro/kernels/ssd_scan.py:86",
                   launches, max(err, case_err), kernel_ms, plain_ms, bound_ms,
                   "bytes" if bytes_ms >= tc_ms else "operations", None, device_ms=on_device_ms,
                   bytes_bound_ms=bytes_ms, tensor_core_bound_ms=tc_ms, f32_cuda_core_bound_ms=flops_ms,
                   err_is="max |error| / max |plain| over y and S, the serving shape and the serve phase's layers")


def phase_rms_times(err: float, rounds: int = 5) -> dict:
    """RMSNorm at (4096, 2560) (8 x 512 tokens of mamba2's d_model), bf16
    and f32: the call (CUDA events, the median of ``rounds`` medians of 30,
    taken in turns with ``F.rms_norm``'s) and the kernel alone on the device
    (the profiler), beside its plain version, ``F.rms_norm`` (call and
    device) and the HBM bound. bf16 goes in the record."""
    rows, d = RMS_TIME_SHAPE
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        g = torch.Generator(device="cuda").manual_seed(17)
        x = torch.randn(rows, d, generator=g, device="cuda").to(dtype)
        sc = torch.randn(d, generator=g, device="cuda").to(dtype)
        case_err = (rms_k.rmsnorm_cuda(x, sc).float() - R.rmsnorm_ref(x, sc).float()).abs().max().item()
        kernel = lambda: rms_k.rmsnorm_cuda(x, sc)  # noqa: E731
        library = lambda: torch.nn.functional.rms_norm(x, (d,), sc, 1e-6)  # noqa: E731
        calls = {"kernel": [], "library": []}
        for _ in range(rounds):
            calls["kernel"].append(median_ms(kernel))
            calls["library"].append(median_ms(library))
        kernel_ms, library_ms = (statistics.median(calls[k]) for k in ("kernel", "library"))
        plain_ms = median_ms(lambda: R.rmsnorm_ref(x, sc))
        on_device_ms = device_ms(kernel, "rmsnorm", per_call=lambda: rms_k.launches)
        two_reads_ms = device_ms(lambda: _rms_two_reads(x, sc), "rmsnorm", per_call=True)
        library_device_ms = device_ms(library, "", per_call=True)
        nbytes = 2 * x.numel() * x.element_size() + sc.numel() * sc.element_size()
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        name = str(dtype)[6:]
        body = "registers" if rms_k.body(d, x.element_size(), True) else "two_reads"
        log("times", f"rmsnorm {RMS_TIME_SHAPE} {name} ({body} body): call {kernel_ms:.4f} ms (median of {rounds} medians: "
                     f"{', '.join(f'{t:.4f}' for t in calls['kernel'])}; kernel on the device {on_device_ms:.4f} ms, "
                     f"{nbytes / on_device_ms / 1e6:.0f} GB/s; the two-read body {two_reads_ms:.4f} ms), "
                     f"F.rms_norm call {library_ms:.4f} ms "
                     f"({', '.join(f'{t:.4f}' for t in calls['library'])}; on the device {library_device_ms:.4f} ms), "
                     f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB), "
                     f"max |error| {case_err:.3e}")
        out[name] = dict(err=case_err, ms=kernel_ms, calls_ms=calls["kernel"], device_ms=on_device_ms,
                         body=body, two_reads_device_ms=two_reads_ms,
                         plain_ms=plain_ms, library_ms=library_ms, library_calls_ms=calls["library"],
                         library_device_ms=library_device_ms, bound_ms=bound_ms)
        del x, sc
    bf16 = out["bfloat16"]
    return _record("rmsnorm", "src/repro_torch/kernels/csrc/rmsnorm.cu", "src/repro/kernels/rmsnorm.py:50", 0,
                   max(err, bf16["err"]), bf16["ms"], bf16["plain_ms"], bf16["bound_ms"], "bytes",
                   bf16["library_ms"], device_ms=bf16["device_ms"], library_device_ms=bf16["library_device_ms"],
                   float32=out["float32"],
                   err_is="max |error|, bf16 (within one bf16 step of the plain version)")


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
    phase_quant_routes()
    phase_start_types()
    train_launches, train_steps, train_peak_gb = phase_train()
    check_train_launches(train_launches, train_steps)
    lifecycle_launches = phase_lifecycle(train_peak_gb)
    bwd = phase_bwd_times(train_launches["flash_attention_bwd"], bwd_err)
    quants = phase_quant_times(train_launches)
    ssd_err = phase_ssd_cases()
    rms_err = phase_rms_cases()
    phase_small_agreement(dataclasses.replace(get_config("mamba2-2.7b").reduced(), d_ff=0), prompt_len=100)
    ssm_launches, ssm_err = phase_serve_ssm()
    ssm_elastic_launches = phase_elastic("mamba2-2.7b")
    ssd = phase_ssd_times(ssm_launches, max(ssd_err, ssm_err))
    rms = phase_rms_times(rms_err)
    # each record's launches: its counts on the main paths, each counted
    # from zero just before its run and read just after. No path runs
    # rmsnorm: as in the JAX package, the model's norms are plain and only
    # ops.rmsnorm reaches the kernel (phases 17 and 21)
    paths = {"serve": {"flash_attention": launches}, "elastic": elastic_launches, "train": train_launches,
             "lifecycle": lifecycle_launches, "serve_mamba2": {"ssd_intra_chunk": ssm_launches},
             "elastic_mamba2": ssm_elastic_launches}
    records = [record, *rows, bwd, *quants, ssd, rms]
    for rec in records:
        rec["launches_by_path"] = {p: counts.get(rec["name"], 0) for p, counts in paths.items()}
        rec["launches"] = sum(rec["launches_by_path"].values())
        assert rec["launches"] > 0 or rec["name"] in ("unpack_rows", "rmsnorm"), rec
    assert [r["name"] for r in records] == [
        "flash_attention", "pack_rows", "scatter_rows", "relayout_rows", "unpack_rows", "flash_attention_bwd",
        "pack_quant_rows", "dequant_scatter_rows", "ssd_intra_chunk", "rmsnorm"]
    log("profile", f"device times from {TRACES['taken']} traces, of which {TRACES['not whole']} were not "
                   f"whole; {TRACES['used not whole']} measurements used a trace that was not")
    log("done", f"{time.perf_counter() - t0:.1f}s")
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
