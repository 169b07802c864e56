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
   shape and seamless's non-causal encoder shapes (8 x 512 and 4 x 1024,
   16 heads of 64), on each route that takes the case (bf16 at head dims
   64, 128 and 256 on the tensor cores and on the CUDA cores; float32 and
   bf16 at 16 and 32 on the CUDA cores);
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
6. forward times at the serving and the training shape and at seamless's
   encoder serving shape (CUDA events, median of 30): the tensor-core
   kernel and its TFLOP/s, the CUDA-core route, the plain version,
   ``scaled_dot_product_attention`` as a yardstick, and the card's bound;
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
   (and the serving shape and seamless's encoder shapes in bf16), on each
   route that takes the case;
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
15. fail-stop recovery at full width: qwen3-1.7b as in 13, seed 0; a
   control run never interrupted (12 steps, the losses and a digest of
   every state tensor's bytes at each step), then four cases, each from a
   fresh controller and each held to the control by the state's digest at
   its step and the next 2 losses, bitwise: DP donors (dp2tp2, ranks 0 and
   1 lost after 3 steps, 24.38 GB streamed from ranks 2 and 3 through
   ``FaultInjector.kill``); the parity spare (dp1tp4 refreshing its XOR
   word every step, rank 3's regions poisoned, 6.10 GB rebuilt from the
   word); the fault matrix (dp2tp2 under the int8 moment wire, a fault
   at an idle boundary, mid-stream and mid-commit of a streamed resize to
   dp2tp4, recovered losslessly to dp1tp2 with no quant launch); the
   checkpoint rung (dp1tp4, ``checkpoint_now`` at step 2, rank 3 lost at
   step 4 without parity: restored and rolled back to step 2). Prints each
   recovery's pause and its parts, bytes, GB/s and peak memory, the
   refresh's and the checkpoint's seconds, and the rung's pause with its
   save against each peer pause; fails on a peak above 1.05x 13's;
16. the new kernels' times (CUDA events, median of 20): the backward (at
   the training shape and at seamless's encoder training shape) and
   its TFLOP/s beside the CUDA-core route,
   ``scaled_dot_product_attention``'s backward and the plain version's, the
   two quant kernels beside their plain versions, each with its bound
   (pack_quant_rows on each route: a stacked-moment row on the grid route,
   4096 embedding rows on the warp route, 128 tiles of 24 rows on the
   block route);
17. the SSD intra-chunk kernel against its plain version (TF32 off): the
   JAX kernel tests' shapes, reduced mamba2's chunk, a ragged sequence
   through ``ops.ssd_scan``, the serving shape, x in f32 and bf16;
18. the RMSNorm kernel against its plain version: rows 1-300, d 128, 256,
   2048, 2560, 2561 and 6400 and a misaligned row, f32 and bf16, both
   bodies (the row in registers, and the two-read body for a d above the
   register cap, an odd d and the misaligned row), each case checked for
   the body it took; on aligned rows the register body's bits against the
   two-read body's;
19. small-input agreement: reduced mamba2 with ``d_ff = 0`` served on the
   card (kernel) and on the CPU (plain path) from the same weights;
20. full-width serve of mamba2-2.7b (64 SSD layers, d_model 2560, 80 heads
   of 64, state 128): ``serve_once``, batch 8, prompt 512, 32 greedy
   tokens; exactly 64 SSD launches per prefill, repeatable tokens, the
   kernel against the plain version on the real inputs of the first and
   last layer, and a ``torch.profiler`` window over one prefill and 4
   decode steps;
21. elastic serving of mamba2-2.7b at full width, as phase 8: params and
   the live fp32 ssd/conv cache move at each of three resizes; launches,
   migrated bytes, the staging bound and the tokens checked as there;
22. the two kernels' times (CUDA events, median of 30): the SSD kernel at
   the serving shape (the call, and the kernel alone on the device) beside
   its plain version and three bounds (the bytes, the TF32 tensor-core
   products it issues, the f32 products on the CUDA cores), RMSNorm at (4096, 2560) bf16
   and f32 beside its plain version and ``F.rms_norm`` (the calls in turns,
   the median of 5 medians, and each kernel alone on the device, the
   two-read body's too), each with its bound;
23. the elastic control plane driving the training controller at full
   width: qwen3-1.7b as in 13, ``WorldPool(capacity=2)``, a pool of 8 ranks
   on the card. Part A: ``ElasticScheduler`` -> ``WireEndpoint`` ->
   ``ControllerEndpoint`` over a trace on fixed steps (a clock of a step
   each 1000 trace seconds): a streamed resize to dp2tp4, a retarget to
   dp1tp4 a step later that adopts the streamed layers, its duplicate
   (coalesced), and a fail-stop of ranks 2 and 3 a step after that, its
   target asked of the endpoint and recovered from the surviving replica;
   then the same commands made directly on a fresh controller, held to the
   scheduler's run by the state's digest and the next 2 losses, bitwise.
   Part B: the fallback lattice on the card's own timings (the wall clock,
   time scale 1, the int8 moment wire, the real estimator, the prefetch
   policy on): an unbounded stream, a window between the estimate's two
   totals (stop-copy), a zero window the peers cover (peer recovery), and a
   stream forced on a window that fits only stop-copy (escalated). Each
   decision held to ``choose_mode`` of the estimate it was made on; prints
   each event's estimated and measured Prepare and pause, ``met_deadline``,
   the goodput, the pause seconds, the speculative builds and the launches
   of the path; fails on a peak above 1.05x 13's. It runs after every
   phase that takes a profiler trace: on the card's machine
   ``torch.profiler`` loses more of a trace's device records the later the
   trace comes in a run, and run after phase 15 this phase left the traces
   of phases 16 and 22 with none. Phases 24-36 run before it, 37-38
   (which take no trace) after it, but 37's mixtral part inside 33, and
   39 right after 13.
24. the SSD backward kernel (``csrc/ssd_scan_bwd.cu``) against the plain
   backward ``ref.ssd_intra_chunk_bwd_ref`` (TF32 off): the JAX kernel
   tests' shapes, reduced mamba2's chunk 8 and state 16, the training shape
   (4 x 1024 tokens, 80 heads of 64, state 128, chunk 64), x in f32 and
   bf16, each at the spans drawn and at a chunk span past 88 (where the
   JAX reference's gradient is NaN); every output finite, within its
   tolerance, a second launch bitwise equal; ``ops.ssd_scan`` on a ragged
   sequence with an initial state, the gradients of x, dt, A, B, C and the
   state against the same glue around ``SSDIntraChunkRef``; each bad
   argument refused;
25. the backward's times at the training shape (CUDA events, median of 30;
   and its two kernels alone on the device): beside the plain backward,
   autograd of the plain forward and the bound, and the TF32 products it
   issues;
26. mamba2-2.7b trained at full width and depth (64 layers, d_model 2560,
   fp32 params, bf16 compute, AdamW, remat per layer), batch 4 x 1024 on
   dp2tp2 under ``LiveRController``: the first step's gradients against
   the same step through ``SSDIntraChunkRef`` (plain forward and backward
   on the card), leaf by leaf, in f32 compute within a tolerance and in
   the run's bf16 compute against one f32 ulp of noise on the plain
   block's outputs (bf16 roundings through 64 layers move every gradient
   by ~7% for either); 4 steps of finite losses, 2 x 64 forward and
   64 backward SSD launches a step; a second run from the same seed
   bitwise equal (losses and a digest of the state); the median step time,
   tokens/s, peak memory, and one step under ``torch.profiler`` (busy
   share, the SSD backward's share);
27. live-resized mamba2 training at full width and 48 of its 64 layers:
   dp2tp2 -> dp1tp2 by stop-copy, then dp1tp2 -> dp2tp2 streamed with the
   split-step commit, lossless; the machine's history passes through
   prepare, ready, switch, cleanup and stable; the losses and the state's
   digest bitwise those of a control run never resized; each commit's
   pause, Prepare and bytes, the peak;
28. ``sim/calibrate.measure`` on the card: every constant;
29. seamless-m4t-large-v2 (enc-dec) at full width and depth: reduced
   seamless served on the card and on the CPU from the same weights and
   frames; then ``serve_once`` (24 encoder + 24 decoder layers, d_model
   1024, 16 heads of 64, vocab 256206), batch 8, prompt 512 with 512
   frames, 32 greedy tokens: 48 flash launches a prefill (24 non-causal,
   24 causal), every one on the tensor cores, repeatable tokens, the
   first encoder and decoder layers' q/k/v held against the plain version
   forward and backward, the cross KV's shapes and dtype, prefill_s,
   decode tokens/s, the peak memory and a ``torch.profiler`` window;
30. elastic serving of seamless at full width, as phase 8, each request
   with 512 frames: params, the self-attention cache and the cross KV
   move at each of three resizes, the cross cells planned at every commit
   and moved where the tp degree changes; launches, bytes, the staging
   bound and the tokens checked as there;
31. seamless trained at full width and depth as qwen3 in 13 (fp32 params,
   bf16 compute, AdamW, remat per layer, batch 4 x 1024 with 1024 frames
   of ``data.SyntheticFrames`` a sample, as the launcher trains it: the
   JAX controller's zero frames give non-finite encoder gradients at 24
   layers; dp2tp2 -> dp2tp4 streamed with int8 moments -> dp1tp4
   stop-copy): first the run's first step's gradients in f32 compute,
   through the kernels against the plain attention, leaf by leaf; then 2
   x 48 forward and 48 backward flash
   launches a step, all on the tensor cores, the commits' bytes, the peak
   memory, the step time and one step under the profiler, and the params
   after the lossless commit bitwise those of a control run never resized.
32. small-input agreement: reduced mixtral-8x7b (MoE, window 64, a
   prompt of two windows) served on the card and on the CPU;
33. mixtral-8x7b at full width (d_model 4096, 32 q / 8 kv heads of 128, 8
   experts top-2 at d_ff 14336, window 4096, vocab 32000) and 8 of its 32
   layers (11.87 B params, 23.74 GB in bf16, drawn part by part in bf16):
   ``serve_once``, batch 8, prompt 512, 32 greedy tokens; one flash launch
   a layer, all on the tensor cores, the first layer's q/k/v held against
   the plain version forward and backward; prefill_s, decode tokens/s, the
   peak memory, the pairs capacity drops in a prefill and a
   ``torch.profiler`` window; then one request of 8192 tokens (two
   windows: the flash kernel masks by the window) and 32 tokens decoded
   through the ring cache, which wraps, teacher-forced, their logits
   against the full forward's (capacity factor num_experts / k there:
   capacity is counted per call): in bf16 each layer's expert choices of
   the two paths compared, the logits held at the positions where none
   differs, and the prefill's first flash launch (8192 tokens, the window
   in effect, the tensor cores) against the plain version forward and
   backward; in f32 compute held at every position. The routing lines
   give each expert's share of a layer's choices, the busiest row's load
   against capacity and the router inputs' likeness by position quarter;
34. elastic serving of mixtral at the same 8 layers, as phase 8 across
   expert-parallel degrees: dp2tp2 -> dp2tp2ep2 -> dp1tp2ep4 -> dp1tp4,
   every commit moving the expert matrices' slices; launches, migrated
   bytes, the staging bound and the tokens checked as there;
35. mixtral trained at full width and 1 layer (1.71 B params; fp32 params,
   bf16 compute, AdamW, remat per layer, the MoE aux loss in the loss),
   batch 4 x 1024: the first step's f32 gradients through the kernels
   against the plain attention's, the share of (token, choice) pairs that
   capacity 1.25 drops and the loads behind it; dp2tp2 -> dp2tp2ep2 streamed with int8 moments ->
   dp1tp2ep4 stop-copy, lossless; the launches, the commits' bytes, the
   peak, the step time and one step under the profiler, and the params
   after the lossless commit bitwise those of a control run never resized;
36. jamba-v0.1-52b at full width and one period, 8 of its 32 layers (1
   attention, 7 SSD, 4 MoE MLPs of 16 experts top-2 and 4 dense; 13.27 B
   params): served as mixtral in 33, the first attention and the first SSD
   layer held against their plain versions; then llama4-scout-17b-a16e the
   same way at full width and 8 of its 48 layers (16 experts top-1 and a
   shared expert at d_ff 8192, d_model 5120, 40 q / 8 kv heads of 128,
   vocab 202048; 19.69 B params, 39.37 GB in bf16). Each served world's
   tensors (params, prompts) equal, leaf by leaf, the dry run's per-chip
   argument bytes on a one-card mesh.
37. chunked prefill (``models.model.prefill_chunked``), run after 23:
   qwen3-1.7b and mamba2-2.7b at full width, batch 8 x 512 in chunks of
   128 (bf16 serving weights), their last logits against whole prefill's
   and 32 greedy tokens of whole prefill fed through the chunked cache
   (the argmax flips listed); the flash launches of the first chunk and of
   the last (512 keys) against the plain version, mamba2's first SSD
   layer's block (its scan continues from the carried state) against the
   plain version; each path's prefill_s (the median of 3 timed runs, and
   when the host's call returned) and peak memory chunked and whole, its
   launches, and qwen3's K/V slice copies timed. Mixtral at 8
   layers (phase 33's weights, run inside it): one request of 8192 tokens
   in chunks of 2048 through the ring of 4096 slots (window 4096: the
   third and fourth chunks attend 6144 keys, the pre-write ring in
   absolute order and the chunk): each chunk's first-layer attention
   output (no routing before it) against the whole prompt's, the last
   logits against the same chunked function with the plain attention
   (capacity is counted per call, so whole prefill drops other pairs),
   failing if any layer's experts for the last token differ there, and the
   first wrapped chunk's flash launch against the plain version;
38. pipeline-parallel training at full width: qwen3-1.7b as in 13 cut
   to 8 of its 28 layers (28 before phase 43 came, for the script's time);
   the first step on pp2tp2 (2 microbatches, ``scan_loss`` with no aux
   term) against dp2tp2 with the same microbatches, in f32 compute at 4
   layers (held) and in bf16 at 8 (printed); then 3 steps on pp2tp2 -> a
   streamed resize with int8 moments to dp2tp2 -> a lossless stop-copy to
   pp4tp1 -> 2 steps. Per commit its pause, Prepare, executed against
   planned bytes, the row and quant launches and the peak; each world's
   step time side by side; the flash launches (2 a layer a microbatch
   forward, 1 backward); the params after the run bitwise those of a
   control that runs the same worlds' steps at the same steps and carries
   the state by plain tensor copies;
39. int8 error-feedback gradient compression at full width: qwen3-1.7b
   as in 13 (28 layers), run right after 13 (it takes no trace; at the
   end of the script the caching allocator's fragments left its ~71 GB
   peak no room), under ``compression="int8_ef"``, 3 steps on
   dp2tp2, a stop-copy to dp1tp4, 2 steps; the ``ef`` buffers pass
   through the commit as they are (the same storage), and their digests
   at the commit's step and after the run equal a control's never
   resized, as do the losses; the step time and the peak.
40. the dry run (``launch/dryrun.py``: the step executed once on the meta
   device under ``roofline/counting.py``) of qwen3-1.7b's own worlds on a
   one-card mesh, run right after 39: training at 4 x 1024 (fp32 params,
   bf16 compute, remat) and prefill at 8 x 512 (bf16 weights). Each world's
   tensors (phase 13's controller's, phase 5's served weights and prompts,
   and the same worlds rebuilt here) equal the predicted argument bytes
   leaf by leaf (asserted); the flash launches a step counted on meta equal
   those on the card; the predicted peak (arguments and the step's own live
   bytes) against ``max_memory_allocated`` over 4 steps (prefills) of the
   rebuilt world and against phase 13's peak, ratios printed; the compute
   and memory terms against the measured step and prefill seconds (no
   limit on times). Then the sweep of qwen3-1.7b's cells on both
   production meshes, in-process, one line a cell (arguments a chip and
   whether they fit in 80 GB, the terms, the bottleneck);
41. the torch examples, run last, each a subprocess on the card with a time
   limit, the three at once: ``examples/quickstart_torch.py`` (reduced qwen3, 40 steps, exits
   non-zero unless the loss drops by more than 0.5 nats),
   ``examples/reshard_demo_torch.py`` (the Fig. 5 and mixed 3D plans
   through the live path, bit-exact) and ``examples/fleet_train_torch.py``
   (the live job on the card's rank pool; every event committed);
42. per-rank training worlds (``core/rank_controller.py``), run right
   after phase 3, while this process holds the least of the card: 4 rank
   processes on the one card under gloo (their messages through pinned
   host memory; their allocators in expandable segments; started once for
   phases 42 and 43, which they run one after the other), qwen3-1.7b at
   full width (d_model 2048, 16/8 heads of 128, d_ff 6144, vocab 151936)
   cut to 2 of its 28 layers, fp32 params, batch 4 x 1024, TF32 off. Rank 0
   first computes, alone, the one-process world's first step in f32 and in
   bf16 compute, and the bf16 step's twin that sums the batch's rows in two
   halves; then every rank computes the first step on its shards in both.
   Assembled on rank 0, the f32 gradients are held to 1e-4 of each leaf's
   largest entry (the limit phase 31 holds its first step's f32 gradients
   to against the plain attention); the bf16 ones may stand at most 2x as
   far from the f32 step as the one-process bf16 ones stand (their gap from
   the one-process bf16 step and the twin's are printed), and the bf16
   step's launches (flash on the tensor cores) are the path
   "rank_train_bf16". Then, in f32 compute (see ``_rank_cfg``), dp2tp2
   trains 1 step, is resized live to dp1tp4 (streamed, every layer in one
   pre-copy round, a split-step commit, the moments on the int8 wire)
   while training goes on, trains 1 step, is resized back to dp2tp2 by
   stop-copy (lossless) and trains 1. At each commit every tensor of the cut is held: params
   (and the lossless commit's moments) bit for bit, by digests of the old
   world's shards and of the new world's summed over the ranks (each word
   weighted by its place in the whole tensor), the int8 commit's moments
   assembled on rank 0's host from both worlds' shards, within their
   tiles' rounding. Rank 0 then runs a
   one-process dp2tp2 control never resized, which takes the moments the
   int8 commit delivered at the same step (as phase 13's control takes the
   int8 round trip), and a witness: from the control's state at that
   commit, the same world summing the rows in two halves, a sound run that
   differs only in summation order. Each cut's params and the final params
   are held against the control's: within 1e-2 (the JAX package's
   RESHAPE_PARITY_TOL) where the delivered moments kept Adam's |mu| <=
   sqrt(nu), and where they broke it (the wire rounded a nu to 0 beside a
   nonzero mu; there Adam divides by ~eps) within 1e-2 or 2x what the
   witness parts from the control there, the larger. Each lossless
   commit's destination world is held by its own steps, from the commit to
   the next one or the end, where the bound held: the run's move there
   less a control's, over the control's move (L2, the largest over leaves;
   a world that skips its update reads 1), within 1e-2. After the int8
   commit the broken entries part the control's path from the run's, so
   that control is one seated on the run's whole state at the cut (its
   moments assembled on rank 0 too); the int8 commit's own world is
   printed beside the witness's. The launches of flash
   forward and backward and of the five row and quant kernels are counted
   in the rank processes and summed into the kernels line as the path
   "rank_train", each nonzero; a rank that fails fails the phase. Prints
   step times beside the control's, the mock warm-up's seconds beside the
   first real step's, each commit's pause and Prepare and the bytes and
   seconds the host staging carried, and the peak memory per rank and on
   the card.
43. per-rank pipeline- and expert-parallel worlds, right after phase 42,
   in the same setting (4 rank processes on the card under gloo, batch 4
   x 1024, f32 compute, TF32 off), in two parts one after the other:
   qwen3-1.7b at 4 of 28 layers on pp2tp2
   with 4 microbatches (the GPipe stage ranks of
   ``distribution/pipeline.py``), streamed (two layers a pre-copy round,
   so that training steps between rounds dirty the layers copied before
   and the commit re-syncs them; a split-step commit, the moments on the
   int8 wire) to dp2tp2 (2 microbatches: its 2 rows a rank) and back by
   stop-copy (lossless); mixtral-8x7b at full width and 1 of 32 layers
   (1.713 B params) on ep2tp2 (``models/moe.py::moe_apply_rank``), streamed
   (lossless) to tp4 and by stop-copy to ep4 (see ``_pp_ep_parts`` for the
   order). In each part rank 0 first
   computes, alone, the one-process world's first step (and records which
   (token, choice) pairs capacity keeps); then every rank computes the
   first step on its shards. Assembled on rank 0, the gradients are held
   to 1e-4 of each leaf's largest entry and the loss to 1e-4 of its value,
   and every route call keeps exactly the pairs one process keeps (every
   rank the same). Then the resized run, each commit's cut held as phase
   42 holds it (params and a lossless commit's moments bit for bit, the
   int8 commit's moments within their tiles' rounding), each rank's
   commits with their bytes by rank pair; rank 0 then runs the
   one-process control never resized (qwen3's on pp2tp2 with 4
   microbatches, taking the int8 commit's moments at its step, and phase
   42's witness on dp2tp2; mixtral's on ep2tp2) and holds the losses and
   each cut's and the final params to 1e-2 (where the int8 moments kept
   |mu| <= sqrt(nu); where they broke it, to 1e-2 or 2x the witness), and
   each commit's destination world by its steps as phase 42 holds them.
   The launches of flash forward and backward and of the row and quant
   kernels on both parts, summed over the ranks, are the path
   "rank_pp_ep", each of qwen3's seven and mixtral's flash, pack and
   scatter nonzero on its part. Prints step_s per rank beside the
   control's, pause_s beside prepare_s for each commit, host-staged bytes
   a step and a commit, bytes by rank pair, the mock warm-up's seconds
   beside the first step's, and the peak memory per rank (each step's on
   rank 0) and on the card.
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
from repro_torch.configs.base import ParallelConfig, ShapeConfig  # noqa: E402
from repro_torch.core.events import ResizeEvent  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ref as R  # noqa: E402
from repro_torch.kernels import reshard_pack as rp  # noqa: E402
from repro_torch.kernels import reshard_quant as rq  # noqa: E402
from repro_torch.kernels import rmsnorm as rms_k  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd_k  # noqa: E402
from repro_torch.kernels import work  # noqa: E402
from repro_torch.kernels.ref import flash_attention_ref  # noqa: E402
from repro_torch.launch.mesh import HBM_BW as HBM_BYTES_PER_S  # noqa: E402
from repro_torch.launch.mesh import MeshSpec  # noqa: E402
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
SEAMLESS = "seamless-m4t-large-v2"
SEAMLESS_SERVE = dict(SERVE, frames_len=512)  # 512 frames: the encoder's real work
SLICE_SHAPE = (8, 512, 512, 16, 8, 128, True, 0)  # the serve phase's prefill attention
# the training path's attention: batch 4 x 1024 tokens, 16 q / 8 kv heads of 128
TRAIN_SHAPE = (4, 1024, 1024, 16, 8, 128, True, 0)
# seamless-m4t-large-v2's encoder self-attention (non-causal, 16 heads of
# 64): the serve phase's prefill over 512 frames, the training batch's
ENC_SERVE_SHAPE = (8, 512, 512, 16, 16, 64, False, 0)
ENC_TRAIN_SHAPE = (4, 1024, 1024, 16, 16, 64, False, 0)
# the bf16 cases past FLASH_CASES: the paths' own shapes
PATH_SHAPES = [SLICE_SHAPE, TRAIN_SHAPE, ENC_SERVE_SHAPE, ENC_TRAIN_SHAPE]
# the libraries whose SASS phase_build reads, and where each runs its
# products: the flash routes, and the SSD backward (mma.sync)
SASS_LIBS = {"flash_attention_tc": "tensor_cores", "flash_attention_bwd_tc": "tensor_cores",
             "flash_attention": "cuda_cores", "flash_attention_bwd": "cuda_cores", "ssd_scan_bwd": "tensor_cores"}


# host clock of each phase tag's last line: main() prints the time from one
# tag's last line to the next's, in time order (a phase that prints only
# when it ends is then counted whole)
PHASE_ENDS: dict = {}


def log(phase: str, msg: str) -> None:
    PHASE_ENDS[phase] = time.perf_counter()
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
    # which instructions carry the products: wgmma is HGMMA in SASS,
    # mma.sync HMMA; the CUDA-core routes have neither
    cuobjdump = Path(build.nvcc()).parent / "cuobjdump"
    for name, route in SASS_LIBS.items():
        sass = subprocess.run([str(cuobjdump), "-sass", str(libs[name])], capture_output=True, text=True,
                              check=True, timeout=120).stdout
        hgmma, hmma = sass.count("HGMMA"), sass.count("HMMA")
        log("build", f"{name} ({route}): SASS has {hgmma} HGMMA and {hmma} HMMA instructions")
        if route == "tensor_cores":
            assert hgmma + hmma > 0, f"{name}: no tensor-core instruction in its SASS"


def phase_kernel_cases() -> None:
    for dtype in (torch.float32, torch.bfloat16):
        for i, case in enumerate(FLASH_CASES + (PATH_SHAPES if dtype == torch.bfloat16 else [])):
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


def phase_small_agreement(cfg=None, prompt_len: int = 96, frames_len: int = 0) -> None:
    """A reduced model in f32 (qwen3 unless ``cfg`` is given), the same
    weights (and, for an enc-dec model, ``frames_len`` seeded frames) on
    the card and on the CPU: the card's path (kernels) against the CPU's
    (plain versions)."""
    cfg = cfg or get_config("qwen3-1.7b").reduced()
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    gpu = _to(params, "cuda")
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, prompt_len), generator=gen)}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn((2, frames_len, cfg.d_model), generator=gen)
    worst, same = 0.0, True
    with torch.inference_mode():
        lc, cc, xc = M.prefill(cfg, params, batch, torch.float32, prompt_len + 4)
        lg, cg, xg = M.prefill(cfg, gpu, _to(batch, "cuda"), torch.float32, prompt_len + 4)
        for i in range(4):
            worst = max(worst, (lg.cpu() - lc).abs().max().item())
            tc, tg = lc[:, -1].argmax(-1, keepdim=True), lg[:, -1].argmax(-1, keepdim=True)
            same &= torch.equal(tc, tg.cpu())
            lc, cc = M.decode_step(cfg, params, cc, tc, prompt_len + i, xc)
            lg, cg = M.decode_step(cfg, gpu, cg, tg, prompt_len + i, xg)
    frames = f", {frames_len} frames" if cfg.family == "encdec" else ""
    log("agree", f"{cfg.name} (d_ff {cfg.d_ff}) f32, prompt {prompt_len}{frames}, card vs CPU: max logit diff "
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
    # the serving world's own tensors (the bits serve_once draws), for the
    # dry run's prediction (phase 40)
    CARD_WORLDS["prefill"] = {"leaves": leaf_bytes(params=params, batch=demo_batch(cfg, SERVE["batch"],
                                                                                       SERVE["prompt_len"])),
                              "prefill_s": out["prefill_s"], "peak_gb": peak_gb}
    phase_profile(cfg, params, logits, cache)
    del params, logits, cache
    torch.cuda.empty_cache()
    return launches, worst


def phase_serve_encdec() -> tuple[int, float]:
    """seamless-m4t-large-v2 at full width and depth served on the card
    (see the module docstring, 29). Returns the flash launches of the
    serving run and the captured layers' worst forward error."""
    import gc

    cfg = get_config(SEAMLESS)
    shape = SEAMLESS_SERVE
    layers = cfg.encoder_layers + cfg.num_layers
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = fa.tc_launches = fa.cc_launches = 0  # the main path's counts start here
    out = serve_once(cfg, device="cuda", seed=0, **shape)
    launches, tc_launches = fa.launches, fa.tc_launches  # ... and are read here
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    toks = out["tokens"]
    tok_s = shape["batch"] * shape["gen"] / out["decode_s"]
    log("serve-encdec", f"{cfg.name} full width ({cfg.encoder_layers} encoder + {cfg.num_layers} decoder layers, "
                        f"d_model {cfg.d_model}, {cfg.num_heads} heads of {cfg.resolved_head_dim}, vocab "
                        f"{cfg.vocab_size}), batch {shape['batch']} x prompt {shape['prompt_len']} with "
                        f"{shape['frames_len']} frames, {shape['gen']} greedy tokens: prefill_s "
                        f"{out['prefill_s']:.4f}, decode_s {out['decode_s']:.4f} ({tok_s:.1f} tok/s), peak memory "
                        f"{peak_gb:.2f} GB, flash launches {launches}")
    # bf16 at head dim 64: every launch on the tensor cores, one a layer
    assert fa.route(getattr(torch, cfg.dtype), cfg.resolved_head_dim) == "tensor_cores"
    assert launches == layers and tc_launches == launches, (launches, tc_launches)
    log("serve-encdec", f"flash launches by route: tensor_cores {tc_launches}, cuda_cores {launches - tc_launches}")
    assert toks.shape == (shape["batch"], shape["gen"] + 1), toks.shape
    assert toks.min() >= 0 and toks.max() < cfg.vocab_size

    # second run: same tokens; every launch's causality, and the q/k/v of
    # the first encoder layer (launch 0) and the first decoder layer
    captured, flags, orig = {}, [], ops.flash_attention

    def capture(q, k, v, **kw):
        flags.append(kw["causal"])
        if len(flags) - 1 in (0, cfg.encoder_layers):
            captured[len(flags) - 1] = (q.clone(), k.clone(), v.clone(), kw)
        return orig(q, k, v, **kw)

    ops.flash_attention = capture
    try:
        again = serve_once(cfg, device="cuda", seed=0, **shape)
    finally:
        ops.flash_attention = orig
    assert (again["tokens"] == toks).all(), "a second run gave other tokens"
    assert flags == [False] * cfg.encoder_layers + [True] * cfg.num_layers, flags
    log("serve-encdec", f"a prefill's flash launches: {flags.count(False)} non-causal (encoder), "
                        f"{flags.count(True)} causal (decoder); a second run's tokens identical")
    worst = 0.0
    for i, (q, k, v, kw) in sorted(captured.items()):
        err = kernel_vs_plain(q, k, v, **kw)
        case = (*q.shape[:2], k.shape[1], q.shape[2], k.shape[2], q.shape[3], kw["causal"], kw["window"])
        rel = bwd_vs_plain(case, q.dtype, seed=i, qkv=(q, k, v), scale=kw["scale"])
        where = "encoder layer 0" if i == 0 else "decoder layer 0"
        log("serve-encdec", f"{where} attention {tuple(q.shape)} {str(q.dtype)[6:]} causal {kw['causal']}: kernel "
                            f"vs plain max_abs_err {err:.3e} (tol {TOL[q.dtype]:g}); backward max |error| / max "
                            f"|plain| {rel:.3e} (tol {BWD_TOL[q.dtype]:g})")
        assert err <= TOL[q.dtype] and rel <= BWD_TOL[q.dtype]
        worst = max(worst, err)
    del captured

    # the logits themselves: finite, of the expected shape, the first tokens
    params = M.cast_params(
        M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda"), cfg.dtype
    )
    batch = demo_batch(cfg, shape["batch"], shape["prompt_len"], frames_len=shape["frames_len"])
    with torch.inference_mode():
        logits, cache, cross = M.prefill(cfg, params, batch, max_seq=shape["prompt_len"] + 4)
    assert logits.shape == (shape["batch"], 1, cfg.vocab_size)
    assert torch.isfinite(logits.float()).all(), "full-width logits not finite"
    assert (logits[:, -1].argmax(-1).cpu().numpy() == toks[:, 0]).all()
    kv = (cfg.num_layers, shape["batch"], shape["frames_len"], cfg.num_kv_heads, cfg.resolved_head_dim)
    assert all(tuple(x.shape) == kv and x.dtype == torch.bfloat16 for c in cross.values() for x in c.values())
    log("serve-encdec", f"full-width prefill logits {tuple(logits.shape)} finite; first tokens match; cross KV "
                        f"{len(cross)} x (k, v) of {kv} bf16")
    phase_profile(cfg, params, logits, cache, cross, frames_len=shape["frames_len"])
    del params, logits, cache, cross
    gc.collect()
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
# that had to use such a trace. Late in a run it also loses whole traces
# (no device event at all; the first trace of each measurement in the
# quant phase, and in one run all three of one): device_ms takes a lost
# trace again, with the wait a side doubled, at most TRACE_LOST_TRIES
# times a measurement, and where the trace after those is lost too it
# times the calls with CUDA events instead (the host's launch gaps
# included), says so and counts it ("lost", "events instead").
TRACE_PAD_S = 0.1
TRACE_TRIES = 3
TRACE_LOST_TRIES = 4
TRACES = {"taken": 0, "not whole": 0, "used not whole": 0, "lost": 0, "events instead": 0}
SPIN_KERNEL = "spin_kernel"  # torch.cuda._sleep's


def open_trace(pad: float = TRACE_PAD_S) -> None:
    """The start of every trace: the wait, then the spin kernel, finished."""
    time.sleep(pad)
    torch.cuda._sleep(100)
    torch.cuda.synchronize()


def device_events(prof) -> list:
    """The device events of a trace but its opening spin kernel's."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and SPIN_KERNEL not in e.name]


def phase_profile(cfg, params, logits, cache, cross=None, frames_len: int = 16) -> None:
    """Where the serve path's time goes: ``torch.profiler`` over one
    full-width prefill and 4 decode steps, device time by kernel class
    against the window's wall time (the profiler's own host cost inflates
    the wall time, so the busy share is a lower bound). ``cross`` and
    ``frames_len``: an enc-dec model's cross-attention KV and frames."""
    from torch.profiler import ProfilerActivity, profile

    batch = demo_batch(cfg, SERVE["batch"], SERVE["prompt_len"], frames_len=frames_len)
    cur = logits[:, -1].argmax(-1, keepdim=True)
    runs = {
        "prefill": lambda: M.prefill(cfg, params, batch, max_seq=SERVE["prompt_len"] + 4),
        "decode x4": lambda: [M.decode_step(cfg, params, cache, cur, SERVE["prompt_len"] + i, cross)
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
            log("profile", f"{cfg.name} {name}: device time not measured (the profiler saw no kernels)")
            continue
        total = sum(busy.values())
        log("profile", f"{cfg.name} {name}: wall {wall_ms:.3f} ms under the profiler, {count} kernels, device busy "
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
    # QK^T and PV over the attended pairs; q, k, v in, o out
    flops, nbytes = work.flash_fwd_bound(b, s, t, h, kh, d, causal, window, q.element_size())
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
    """The forward at the serving shape (the record's numbers), at the
    training shape and at seamless's encoder shape (non-causal, heads of
    64; both kept in the record beside them)."""
    serve, train, enc = _fwd_times(SLICE_SHAPE), _fwd_times(TRAIN_SHAPE), _fwd_times(ENC_SERVE_SHAPE)
    # these shapes and the serve phase's real layers
    max_err = max(serve["err"], train["err"], enc["err"], serve_err)
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
        "encoder_shape": {k: v for k, v in enc.items() if k != "err"} | {"shape": list(ENC_SERVE_SHAPE)},
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
ELASTIC = dict(n_slots=8, prompt_len=512, max_seq=544, gen=32, frames_len=512)  # frames: seamless's
# (time, target): every elastic serving run starts on dp2tp2
ELASTIC_TRACE = [(8.0, ParallelConfig(dp=1, tp=2)), (16.0, ParallelConfig(dp=1, tp=4)),
                 (24.0, ParallelConfig(dp=2, tp=2))]


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


def _short(p: ParallelConfig) -> str:
    return f"dp{p.dp}" + (f"pp{p.pp}" if p.pp > 1 else "") + f"tp{p.tp}" + (f"ep{p.ep}" if p.ep > 1 else "")


def elastic_session(cfg, prompts, trace, frames=None):
    """``prompts`` served on dp2tp2 through ``trace`` ((time, target)
    pairs); ``frames``, one array a prompt, feed an enc-dec model's
    encoder."""
    frames = frames if frames is not None else [None] * len(prompts)
    ctrl = LiveServeController(cfg, ParallelConfig(dp=2, tp=2), ELASTIC["n_slots"], ELASTIC["prompt_len"],
                               ELASTIC["max_seq"], cache_dtype=torch.bfloat16, frames_len=ELASTIC["frames_len"],
                               device="cuda", sync_prepare=True)
    sess = ServeSession(ctrl, step_time_s=1.0)
    for p, f in zip(prompts, frames):
        sess.submit(p, ELASTIC["gen"], frames=f)
    results, metrics = sess.run([ResizeEvent(time_s=t, target=target) for t, target in trace])
    records = list(ctrl.records)
    ctrl.shutdown()
    return results, metrics, records


def elastic_run(cfg, trace) -> dict:
    """``cfg`` at full width serves 8 requests (512-token prompts, 32 greedy
    tokens; an enc-dec model with 512 frames each) on dp2tp2 through
    ``trace``, then the same requests uninterrupted. A wrapper around
    ``live_reshard_planned`` counts each commit's launches, checks every
    migrated tensor against its source byte for byte and the staging bound.
    Checks the commits' count, the tokens against the uninterrupted run's
    and the path's launches of the row kernels; logs the state and each
    commit, and returns the records, the commits and the path's launches."""
    import gc

    encdec = cfg.family == "encdec"
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, ELASTIC["prompt_len"]) for _ in range(ELASTIC["n_slots"])]
    frames = None
    if encdec:
        frames = [rng.standard_normal((ELASTIC["frames_len"], cfg.d_model), dtype=np.float32)
                  for _ in range(ELASTIC["n_slots"])]
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
            "cross": {t.tensor for t in plan.tasks if t.collection == "cross"},
            "cross_moved": {t.tensor for t in plan.tasks if t.collection == "cross" and t.kind != "resident"},
            "moved": {t.tensor for t in plan.tasks if t.kind != "resident"},
        })
        return dst, stats

    gc.collect()
    torch.cuda.empty_cache()
    serve_controller.live_reshard_planned, ops.relayout_rows = checked, relayout_recorded
    try:
        fa.launches = ssd_k.launches = 0  # the elastic path's counts start here ...
        for k in rp.launches:
            rp.launches[k] = 0
        results, metrics, records = elastic_session(cfg, prompts, trace, frames)
        # ... and are read here
        launches = {"flash_attention": fa.launches, "ssd_intra_chunk": ssd_k.launches, **rp.launches}
    finally:
        serve_controller.live_reshard_planned, ops.relayout_rows = orig_reshard, orig_relayout
    gc.collect()
    torch.cuda.empty_cache()
    plain, _, _ = elastic_session(cfg, prompts, [], frames)
    gc.collect()
    torch.cuda.empty_cache()
    specs = serve_controller.serve_state_specs(cfg, ELASTIC["n_slots"], ELASTIC["max_seq"], torch.bfloat16,
                                               cross_len=ELASTIC["frames_len"] if encdec else 0)
    state_gb = sum(s.nbytes for s in specs) / 1e9
    by_coll = {c: sum(s.nbytes for s in specs if s.collection == c) / 1e9 for c in ("params", "cache", "cross")}
    log("elastic", f"{cfg.name} full width, {cfg.num_layers} layers (serving state {state_gb:.4f} GB: params "
                   f"{by_coll['params']:.4f}, cache {by_coll['cache']:.4f}, cross KV {by_coll['cross']:.4f}), "
                   f"{ELASTIC['n_slots']} requests x prompt {ELASTIC['prompt_len']}"
                   + (f" with {ELASTIC['frames_len']} frames each" if encdec else "") + ", "
                   f"{ELASTIC['gen']} greedy tokens, dp2tp2 -> " + " -> ".join(_short(t) for _, t in trace)
                   + f": {metrics.commits} commits, {metrics.tokens_emitted} tokens, dropped {metrics.dropped}, "
                     f"wall {metrics.wall_s:.3f}s; main-path launches {launches}")
    assert metrics.commits == len(trace) and len(records) == len(trace) == len(commits), (
        metrics.commits, len(records))
    for i, (rec, c) in enumerate(zip(records, commits)):
        pause_s = rec.pause_s - c["check_s"]  # the smoke's own equality check is not the system's pause
        plane_s = pause_s - rec.plan_s
        log("elastic", f"commit {i + 1} {rec.src} -> {rec.dst}: cut_step {rec.cut_step}, pause_s {pause_s:.4f}, "
                       f"plan_s {rec.plan_s:.4f}, executed {rec.executed_bytes / 1e9:.4f} GB, data plane "
                       f"{rec.executed_bytes / 1e9 / plane_s:.1f} GB/s over {plane_s:.4f}s, peak memory "
                       f"{c['peak_gb']:.2f} GB, launches {c['launched']}, relayout on {c['relayout']}, "
                       f"cache-resident layers {rec.cache_resident_layers}, resident tensors adopted "
                       f"{rec.skipped_bytes / 1e9:.4f} GB"
                       + (f", cross KV moved {sorted(c['cross_moved'])}" if encdec else ""))
        assert rec.cut_step > 0, rec.cut_step
    assert all(launches[k] == sum(c["launched"][k] for c in commits) for k in ROW_KERNELS)
    assert results == plain, "the resized run's tokens differ from the uninterrupted run's"
    assert all(0 <= t < cfg.vocab_size for toks in results.values() for t in toks)
    assert all(len(toks) == ELASTIC["gen"] for toks in results.values()) and len(results) == ELASTIC["n_slots"]
    log("elastic", "tokens equal the uninterrupted dp2tp2 run; every migrated tensor equals its source")
    return {"records": records, "commits": commits, "launches": launches}


def phase_elastic(arch: str = "qwen3-1.7b") -> dict:
    """``arch`` (qwen3-1.7b, mamba2-2.7b or seamless-m4t-large-v2) at full
    width served through ``elastic_run`` on ``ELASTIC_TRACE``: three resizes
    mid-generation; params and the live cache (KV, or the SSD and conv
    states, and seamless's cross-attention KV) move through the planner,
    the engine and the row kernels."""
    cfg = get_config(arch)
    encdec = cfg.family == "encdec"
    mixer = "ssd_intra_chunk" if cfg.family == "ssm" else "flash_attention"
    run = elastic_run(cfg, ELASTIC_TRACE)
    records, commits, launches = run["records"], run["commits"], run["launches"]
    first, second, third = commits
    assert not any(first["launched"].values()) and records[0].executed_bytes == 0, first["launched"]
    assert second["launched"]["relayout_rows"] == 0 and not second["relayout"]
    # the tensors that stay whole on every rank: the embedding and the final
    # norms (seamless's encoder has one too)
    norms = ["params/encoder/final_norm/scale"] if encdec else []
    assert third["relayout"] == ["params/embed/tok", *norms, "params/final_norm/scale"], third["relayout"]
    for c in (second, third):
        assert c["launched"]["pack_rows"] == c["launched"]["scatter_rows"] > 0, c["launched"]
        assert c["launched"]["unpack_rows"] == 0
    # the cross KV is planned at every commit and moves where tp changes
    # (16 kv heads over 2, then 4, then 2 ranks)
    cross = {"cross/pos0/k", "cross/pos0/v"} if encdec else set()
    assert all(c["cross"] == cross for c in commits), [c["cross"] for c in commits]
    assert [c["cross_moved"] for c in commits] == [set(), cross, cross], [c["cross_moved"] for c in commits]
    layers = cfg.num_layers + cfg.encoder_layers  # flash layers (and SSD layers) of a prefill
    assert launches[mixer] == layers, launches  # one wave, one prefill
    assert launches["flash_attention"] + launches["ssd_intra_chunk"] == layers, launches
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
    used, else the one with the most matching events. A trace with no
    device event at all is lost and taken again (TRACE_LOST_TRIES); where
    the profiler saw nothing of the calls, CUDA events time them
    (``_events_ms``)."""
    from torch.profiler import ProfilerActivity, profile

    names = (kernel,) if isinstance(kernel, str) else kernel
    fn()
    torch.cuda.synchronize()
    best = None
    tries = lost = 0
    pad = TRACE_PAD_S
    while tries < TRACE_TRIES:
        counted = per_call() if callable(per_call) else 0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            open_trace(pad)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            time.sleep(pad)
        expected = calls
        if callable(per_call):
            counted = (per_call() - counted) / calls
            assert counted > 0, "the wrapper counted no launch"
            expected = round(counted * calls)
        by_kernel: dict[str, list[float]] = {}
        events = device_events(prof)
        if not events:
            TRACES["taken"] += 1
            TRACES["lost"] += 1
            lost += 1
            if lost > TRACE_LOST_TRIES:
                if best is None or best[0] == 0:
                    return _events_ms(fn, names, calls, lost)
                TRACES["used not whole"] += 1
                break
            pad *= 2
            log("profile", f"a trace of {names} held no device event: taken again, {pad:g}s a side")
            continue
        tries += 1
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


def _events_ms(fn, names, calls: int, lost: int) -> float:
    """device_ms where the profiler lost every trace: ``calls`` calls of
    ``fn`` between two CUDA events, over the calls (the host's gaps between
    launches included, so at least the kernels' time)."""
    TRACES["events instead"] += 1
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / calls
    log("profile", f"the profiler lost all {lost} traces of {names}: {ms:.4f} ms a call from CUDA events over "
                   f"{calls} calls stands for the device time (host gaps included)")
    return ms


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
        for i, case in enumerate(FLASH_CASES + [TRAIN_SHAPE] + (
                [SLICE_SHAPE, ENC_SERVE_SHAPE, ENC_TRAIN_SHAPE] if dtype == torch.bfloat16 else [])):
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
            "ssd_intra_chunk": ssd_k.launches, "ssd_intra_chunk_bwd": ssd_k.bwd_launches,
            **rp.launches, **rq.launches, **{f"pack_quant_rows_{k}": v for k, v in rq.route_launches.items()}}


def _zero_counts() -> None:
    fa.launches = fa.bwd_launches = fa.tc_launches = fa.cc_launches = fa.tc_bwd_launches = fa.cc_bwd_launches = 0
    ssd_k.launches = ssd_k.bwd_launches = 0
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


def _flash_class(name: str) -> str:
    if any(k in name for k in ("bwd_dkdv", "bwd_dq", "bwd_rowdot")):
        return "flash backward"
    return "flash forward" if "fa_fwd" in name else _kernel_class(name)


def profile_step(world, params, opt_state, batch, classify) -> dict:
    """One train step on ``world`` under ``torch.profiler``, its two halves
    (gradients, update) apart: the wall time, each half on the card's
    clock, and the device time by ``classify(kernel name)`` and by kernel
    (both empty when the profiler saw no kernel). The step changes the
    state."""
    from torch.profiler import ProfilerActivity, profile

    marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        open_trace()
        t0 = time.perf_counter()
        marks[0].record()
        _, _, grads = world.grad_fn(params, batch)
        marks[1].record()
        world.update_fn(grads, opt_state, params)
        marks[2].record()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(TRACE_PAD_S)
    del grads
    busy: dict[str, float] = {}
    by_name: dict[str, float] = {}
    for e in device_events(prof):
        cls = classify(e.name)
        ms = e.time_range.elapsed_us() / 1e3
        busy[cls] = busy.get(cls, 0.0) + ms
        by_name[e.name] = by_name.get(e.name, 0.0) + ms
    return {"wall_ms": wall_ms, "grads_ms": marks[0].elapsed_time(marks[1]),
            "update_ms": marks[1].elapsed_time(marks[2]), "busy": busy, "by_name": by_name}


def int8_control(cfg, opt, kw, first: dict, at_commit: int):
    """The control of a resized run on dp2tp2: never resized, the same int8
    round trip of its moments at the first commit's cut (what the wire
    delivered there, ``first["quantized"]``), trained to step
    ``at_commit``. Returns the controller and its losses."""
    from repro_torch.core.controller import LiveRController
    from repro_torch.utils.pytree import tree_paths

    control = LiveRController(cfg, ParallelConfig(dp=2, tp=2), opt, **kw)
    losses = control.train_steps(first["step"])
    with torch.no_grad():
        for coll in ("mu", "nu"):
            for p, x in tree_paths(control.opt_state[coll]).items():
                if f"{coll}/{p}" in first["quantized"]:
                    x.copy_(_round_trip_rows(x, "int8"))
    losses += control.train_steps(at_commit - first["step"])
    return control, losses


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
        # the world's own tensors, for the dry run's prediction (phase 40)
        CARD_WORLDS["train"] = {"leaves": leaf_bytes(params=ctrl.params, opt=ctrl.opt_state, batch=ctrl._batch())}
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
    log_step_profile("train", "one step on dp1tp4", profile_step(ctrl.world, ctrl.params, ctrl.opt_state,
                                                                 ctrl._batch(), _flash_class))
    # iteration i ran step i + 1; the split commit ran inside the step at
    # its cut, the stop-copy commit at the boundary after the step before it
    with_commit = {first["step"], second["step"] - 1}
    plain_steps = [t for i, t in enumerate(ctrl.iteration_times) if i not in with_commit]
    log("train", f"step time on the card (host clock, steps without a commit; pre-copy rounds included): "
                 f"median {statistics.median(plain_steps):.4f} s over {len(plain_steps)} steps, "
                 f"{TRAIN['batch'] * TRAIN['seq'] / statistics.median(plain_steps):.0f} tokens/s")
    CARD_WORLDS["train"].update(step_s=statistics.median(plain_steps), peak_gb=peak_gb)
    del ctrl
    torch.cuda.empty_cache()

    control, c_losses = int8_control(cfg, opt, kw, first, at_commit)
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


def log_step_profile(phase: str, what: str, prof: dict, share_of: str = "") -> None:
    """The lines of a ``profile_step``: the busy time by class (and
    ``share_of``'s share of it), then the 8 longest kernels."""
    busy, total = prof["busy"], sum(prof["busy"].values())
    if total == 0:
        log(phase, f"{what} under the profiler: device time not measured (the profiler saw no kernels)")
        return
    share = (f"; the {share_of} {busy.get(share_of, 0.0):.3f} ms "
             f"({100 * busy.get(share_of, 0.0) / total:.1f}% of the busy time)") if share_of else ""
    log(phase, f"{what} under the profiler: wall {prof['wall_ms']:.3f} ms (gradients {prof['grads_ms']:.3f} ms, "
               f"AdamW update {prof['update_ms']:.3f} ms on the card's clock), device busy {total:.3f} ms "
               f"({100 * total / prof['wall_ms']:.1f}%){share}: "
               + ", ".join(f"{k} {v:.3f} ms" for k, v in sorted(busy.items(), key=lambda kv: -kv[1])))
    for kname, ms in sorted(prof["by_name"].items(), key=lambda kv: -kv[1])[:8]:
        log(phase, f"  step: {ms:8.3f} ms  {kname[:110]}")


def check_train_launches(launches: dict, steps: int, arch=TRAIN["arch"], phase: str = "train") -> None:
    """Every kernel of the training path ran on it: the forward twice an
    attention layer a step (remat reruns it; an enc-dec model's encoder
    layers count), the backward once, the quant kernels in the streamed
    commit, the row kernels in it too. qwen3, seamless and mixtral compute
    in bf16 at head dim 128 and 64, so every flash launch is on the tensor
    cores. ``arch`` is a name or a config."""
    cfg = get_config(arch) if isinstance(arch, str) else arch
    layers = cfg.num_layers + cfg.encoder_layers
    for name in ("flash_attention", "flash_attention_bwd", "pack_rows", "scatter_rows",
                 "pack_quant_rows", "dequant_scatter_rows"):
        assert launches[name] > 0, f"{name} was not launched on the training path"
    assert launches["flash_attention_bwd"] == layers * steps, launches
    assert launches["flash_attention"] == 2 * layers * steps, launches
    assert fa.route(getattr(torch, cfg.dtype), cfg.resolved_head_dim) == "tensor_cores"
    assert launches["flash_attention_tc"] == launches["flash_attention"], launches
    assert launches["flash_attention_bwd_tc"] == launches["flash_attention_bwd"], launches
    log(phase, f"flash launches by route: forward {launches['flash_attention_tc']} tensor_cores / "
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


# the recovery phase: qwen3-1.7b as in TRAIN, lossless but for the fault
# matrix's int8 moment wire; stream_k 10 streams its 29 layers in 3 rounds
RECOVERY = dict(control_steps=12, before=3, after=2, stream_k=10, ckpt_at=2, lost_at=4)
DIGEST_CHUNK = 1 << 24  # 32-bit words a digest pass reads at once


def _shard_digest(x: torch.Tensor, spec=None, view=None) -> torch.Tensor:
    """Two wrapping int64 sums of the 32-bit (16-bit) words of the shard
    ``x``, the box ``view`` of the tensor ``spec`` (both default to ``x``
    whole), on its device: plain, and weighted by 1 + each word's flat
    index in the whole tensor. The shards of a world sum to the whole
    tensor's digest, whatever its layout; equal bytes give equal digests,
    and a changed or moved word changes them."""
    shape = tuple(spec.shape) if spec is not None else tuple(x.shape)
    bounds = view.bounds if view is not None else tuple((0, n) for n in shape)
    word = torch.int32 if x.element_size() % 4 == 0 else torch.int16
    per = x.element_size() // (4 if word == torch.int32 else 2)  # words an element
    whole = [math.prod(shape[d + 1:]) for d in range(len(shape))]
    local = [math.prod(x.shape[d + 1:]) for d in range(len(shape))]
    words = x.detach().reshape(-1).view(word)
    out = torch.zeros(2, dtype=torch.int64, device=x.device)
    for lo in range(0, words.numel(), DIGEST_CHUNK):
        c = words[lo:lo + DIGEST_CHUNK].to(torch.int64)
        j = torch.arange(lo, lo + c.numel(), dtype=torch.int64, device=x.device)
        if tuple(x.shape) == shape:
            idx = j + 1
        else:
            e, idx = j // per, j % per + 1
            for d, (lo_d, _) in enumerate(bounds):
                idx += (e // local[d] % x.shape[d] + lo_d) * whole[d] * per
        out += torch.stack([c.sum(), (c * idx).sum()])
    return out


def state_digest(ctrl) -> dict:
    """The digest of every tensor of the training state (params, moments
    and the step count), by name; one wait for the card."""
    from repro_torch.core.reshard import named_state_leaves

    named, extras = named_state_leaves(ctrl.params, ctrl.opt_state)
    names = [*named, "count"]
    sums = torch.stack([_shard_digest(x) for x in [*named.values(), extras["count"]]]).tolist()
    return dict(zip(names, map(tuple, sums)))


def _take_counts(into: dict) -> dict:
    """The launches since the counts were last zeroed, added into ``into``;
    the counts start from zero again."""
    got = _all_counts()
    for k, v in got.items():
        into[k] = into.get(k, 0) + v
    _zero_counts()
    return got


def phase_recovery(train_peak_gb: float) -> dict:
    """Fail-stop recovery at full width (see the module docstring, 15): a
    control run never interrupted, then four cases from fresh controllers,
    each held to the control by the state's digest and the next losses.
    Returns the launches of the path (the cases, not the control)."""
    import gc
    import shutil
    import tempfile

    from repro_torch.core.controller import LiveRController
    from repro_torch.core.reshard import named_state_leaves, plan_state_transfer
    from repro_torch.core.resource_view import build_tensor_specs
    from repro_torch.elastic import FaultInjector
    from repro_torch.elastic.redundancy import _shard_groups, survivors_for
    from repro_torch.optim import AdamWConfig
    from repro_torch.reshard import WirePolicy

    cfg = get_config(TRAIN["arch"])
    opt = AdamWConfig(learning_rate=1e-4, warmup_steps=2, total_steps=1000)
    kw = dict(seq_len=TRAIN["seq"], global_batch=TRAIN["batch"], device=TRAIN["device"])
    P = ParallelConfig
    DP2TP2, DP1TP2, DP1TP4, DP2TP4 = P(dp=2, tp=2), P(dp=1, tp=2), P(dp=1, tp=4), P(dp=2, tp=4)
    peaks: list[float] = []

    def fresh(parallel, **extra):
        gc.collect()  # the last case's controller, whatever cycle holds it
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        return LiveRController(cfg, parallel, opt, **kw, **extra)

    def peak() -> float:
        peaks.append(torch.cuda.max_memory_allocated() / 1e9)
        return peaks[-1]

    # the control: never interrupted
    t0 = time.perf_counter()
    ctrl = fresh(DP2TP2)
    digests, losses = [state_digest(ctrl)], []
    for _ in range(RECOVERY["control_steps"]):
        losses += ctrl.train_steps(1)
        digests.append(state_digest(ctrl))
    log("recovery", f"control {DP2TP2.describe()}: {len(losses)} steps in {time.perf_counter() - t0:.1f}s, losses "
                    f"{[round(x, 4) for x in losses]}, peak {peak():.2f} GB, a digest of {len(digests[0])} "
                    "tensors at each step")
    del ctrl

    def held(ctrl, what: str) -> None:
        """The state is the control's at this step, and so are the next
        losses."""
        step = ctrl.step
        assert state_digest(ctrl) == digests[step], f"{what}: the state differs from the control's at step {step}"
        got = ctrl.train_steps(RECOVERY["after"])
        assert got == losses[step : step + RECOVERY["after"]], f"{what}: losses {got} differ from the control's"
        assert all(np.isfinite(got))

    def show(what: str, rec, step: int, quant=None) -> None:
        rate = rec.executed_bytes / rec.transfer_s / 1e9 if rec.executed_bytes else 0.0
        rest = rec.total_pause_s - rec.plan_s - rec.prepare_s - rec.drain_s - rec.transfer_s - rec.switch_s
        log("recovery", f"{what}: {rec.mode}/{rec.outcome} {rec.src} -> {rec.dst}, step after {step}: "
                        f"pause_s {rec.total_pause_s:.4f} (plan_s {rec.plan_s:.4f}, "
                        f"prepare_s {rec.prepare_s:.4f} [{rec.prepare_source}], drain_s {rec.drain_s:.4f}, "
                        f"transfer_s {rec.transfer_s:.4f}, switch_s {rec.switch_s:.4f}, the rest {rest:.4f}: "
                        "the session's drain, the parity repair), moved "
                        f"{rec.executed_bytes / 1e9:.4f} GB ({rate:.1f} GB/s), parity {rec.parity_bytes / 1e9:.4f} "
                        f"GB, donors {rec.donors}, lost {rec.lost_devices}, peak {peak():.2f} GB"
                        + ("" if quant is None else f", quant launches in the recovery {quant}"))

    path: dict = {}
    pauses: dict[str, float] = {}
    _zero_counts()  # the recovery path's counts start here ...

    # 1. DP donors: ranks 0 and 1 lost, their replicas 2 and 3 donate
    ctrl = fresh(DP2TP2)
    ctrl.train_steps(RECOVERY["before"])
    _take_counts(path)
    rep = FaultInjector(ctrl).kill(DP1TP2, lost_ranks=(0, 1))
    rc = _take_counts(path)
    rec = ctrl.records[-1]
    assert (rep.mode, rep.donors, rep.step_before, rep.step_after) == ("peer_recover", 2, 3, 3), rep
    assert rc["pack_rows"] > 0 and rc["pack_rows"] == rc["scatter_rows"] and rc["pack_quant_rows"] == 0, rc
    show("dp donors, lost (0, 1)", rec, ctrl.step)
    pauses["dp donors"] = rec.total_pause_s
    held(ctrl, "dp donors")
    del ctrl, rec

    # 2. the parity spare: dp1tp4, rank 3 lost, its regions poisoned after
    # the last refresh so that only the word can give them back
    ctrl = fresh(DP1TP4, parity_every=1)
    ctrl.train_steps(RECOVERY["before"])
    store = ctrl._parity
    assert store.covers(RECOVERY["before"])
    refresh = (store.last_refresh_s, store.refreshed_bytes, ctrl.iteration_times[-1])
    specs = build_tensor_specs(cfg, include_optimizer=True, zero_sharding=False)
    named, _ = named_state_leaves(ctrl.params, ctrl.opt_state)
    for sp in specs:
        for bounds, owners in _shard_groups(sp, DP1TP4):
            if owners == [3]:
                named[sp.name][tuple(slice(lo, hi) for lo, hi in bounds)].fill_(-777.0)
    del named
    _, plan = plan_state_transfer(cfg, DP1TP4, DP1TP2, allowed_src=survivors_for(DP1TP4, (3,)))
    lost_bytes = plan.lost_bytes
    del plan
    _take_counts(path)
    rep = FaultInjector(ctrl).kill(DP1TP2, lost_ranks=(3,))
    rc = _take_counts(path)
    rec = ctrl.records[-1]
    assert (rep.mode, rep.step_after) == ("peer_recover", RECOVERY["before"]) and rep.parity_bytes == lost_bytes, rep
    assert rc["pack_quant_rows"] == 0, rc
    log("recovery", f"parity refresh at dp1tp4: {refresh[0]:.4f} s for a {refresh[1] / 1e9:.4f} GB word to host "
                    f"memory ({refresh[1] / refresh[0] / 1e9:.1f} GB/s), beside a step of {refresh[2]:.4f} s")
    show("parity spare, lost (3,)", rec, ctrl.step)
    pauses["parity spare"] = rec.total_pause_s
    held(ctrl, "parity spare")
    del ctrl, rec, store

    # 3. the fault matrix: a fault at each phase of a streamed resize to
    # dp2tp4 under the int8 moment wire; the recovery is lossless
    for phase in ("idle", "mid_stream", "mid_commit"):
        ctrl = fresh(DP2TP2, overlap="stream", stream_k=RECOVERY["stream_k"], wire_policy=WirePolicy())
        ctrl.train_steps(RECOVERY["before"])
        quant: dict = {}

        def counted(self, *args, _quant=quant, **kwargs):
            _take_counts(path)
            try:
                return recover(self, *args, **kwargs)
            finally:
                _quant.update(_take_counts(path))

        recover, LiveRController.fail_stop_recover = LiveRController.fail_stop_recover, counted
        try:
            rep = FaultInjector(ctrl).inject(phase, DP1TP2, lost_ranks=(2, 3), resize_target=DP2TP4)
        finally:
            LiveRController.fail_stop_recover = recover
        rec = ctrl.records[-1]
        assert (rep.phase, rep.mode, rep.outcome) == (phase, "peer_recover", "committed"), rep
        assert rep.step_before == rep.step_after and quant["pack_quant_rows"] == quant["dequant_scatter_rows"] == 0
        show(f"fault matrix, {phase}, lost (2, 3)", rec, ctrl.step, quant["pack_quant_rows"])
        pauses[f"fault {phase}"] = rec.total_pause_s
        held(ctrl, f"fault {phase}")
        del ctrl, rec

    # 4. the checkpoint rung: dp1tp4 without parity, rank 3 lost; the step
    # rolls back to the checkpoint's
    ckpt_dir = tempfile.mkdtemp(prefix="_recovery_ckpt_", dir=Path(__file__).resolve().parent)
    try:
        ctrl = fresh(DP1TP4, ckpt_dir=ckpt_dir)
        ctrl.train_steps(RECOVERY["ckpt_at"])
        t0 = time.perf_counter()
        ctrl.checkpoint_now()
        save_s = time.perf_counter() - t0
        snap_s, write_s = ctrl._ckpt.last_snapshot_seconds, ctrl._ckpt.last_save_seconds
        ctrl.train_steps(RECOVERY["lost_at"] - RECOVERY["ckpt_at"])
        _take_counts(path)
        rep = FaultInjector(ctrl).kill(DP1TP2, lost_ranks=(3,))
        rc = _take_counts(path)
        rec = ctrl.records[-1]
        assert (rep.mode, rep.outcome, rep.step_after) == ("fallback", "fell_back", RECOVERY["ckpt_at"]), rep
        assert sum(rc.values()) == 0, rc  # the restore launches no kernel
        state_gb = sum(sp.nbytes for sp in build_tensor_specs(cfg, include_optimizer=True, zero_sharding=False)) / 1e9
        log("recovery", f"checkpoint of step {RECOVERY['ckpt_at']} ({state_gb:.4f} GB of state): checkpoint_now "
                        f"{save_s:.4f} s (snapshot to host {snap_s:.4f} s, write {write_s:.4f} s); restore (load "
                        f"into the live tensors) {rec.transfer_s:.4f} s ({state_gb / rec.transfer_s:.2f} GB/s)")
        show(f"checkpoint rung, lost (3,) at step {RECOVERY['lost_at']}", rec, ctrl.step)
        rung_s = rec.total_pause_s + save_s
        held(ctrl, "checkpoint rung")
        del ctrl, rec
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    _take_counts(path)  # ... and are read here
    log("recovery", f"the checkpoint rung's pause with its save, {rung_s:.4f} s, against each peer recovery's: "
                    + ", ".join(f"{k} {v:.4f} s ({rung_s / v:.1f}x)" for k, v in pauses.items()))
    phase_peak = max(peaks)
    log("recovery", f"every case's state equal to the control's at its step and its next {RECOVERY['after']} "
                    f"losses bitwise; peak memory {phase_peak:.2f} GB (train phase {train_peak_gb:.2f} GB); "
                    f"launches {path}")
    assert phase_peak <= TOL_PEAK * train_peak_gb, f"peak {phase_peak:.2f} GB: a second set of the state?"
    torch.cuda.empty_cache()
    for name in ("flash_attention", "flash_attention_bwd", "pack_rows", "scatter_rows", "pack_quant_rows",
                 "dequant_scatter_rows"):
        assert path[name] > 0, f"{name} was not launched on the recovery path"
    return path


# the schedule phase: qwen3-1.7b as in TRAIN; Part A's events land on fixed
# steps (a clock of STEP_CLOCK_S trace seconds a step), Part B's on the wall
# clock at time scale 1
SCHEDULE = dict(before=2, tail=2, after=2, pool_ranks=8, prefetch_k=2, safety=1.25)
STEP_CLOCK_S = 1000.0  # far above the wall time of any one command


def _schedule_endpoints():
    """Two endpoint wrappers of the phase, over the port's ``Endpoint``:
    ``StepClock`` reports a clock of ``STEP_CLOCK_S`` a train step, so that
    the scheduler's events land on fixed steps whatever the wall clock does;
    ``Estimates`` keeps every estimate the scheduler was answered."""
    from repro_torch.elastic import Endpoint
    from repro_torch.elastic import protocol as pr

    class Wrapper(Endpoint):
        def __init__(self, inner):
            self.inner, self.kind = inner, inner.kind

        @property
        def prefetch(self):
            return getattr(self.inner, "prefetch", None)

    class StepClock(Wrapper):
        steps = 0

        def handle(self, cmd):
            resp = self.inner.handle(cmd)
            if isinstance(resp, pr.StepResult):
                self.steps += resp.steps
                resp = pr.StepResult(steps=resp.steps, clock_s=self.steps * STEP_CLOCK_S)
            return resp

    class Estimates(Wrapper):
        def __init__(self, inner):
            super().__init__(inner)
            self.seen: list = []

        def handle(self, cmd):
            resp = self.inner.handle(cmd)
            if isinstance(resp, pr.EstimateResponse):
                self.seen.append(resp.estimate)
            return resp

    return StepClock, Estimates


def phase_schedule(train_peak_gb: float) -> dict:
    """The elastic control plane driving the training controller at full
    width (see the module docstring, 23): Part A, a scheduler-driven trace
    against the same commands made directly, bitwise; Part B, the fallback
    lattice on the card's own timings. Returns the launches of the path
    (the scheduler's runs, not the direct run)."""
    import gc

    from repro_torch.core.controller import LiveRController
    from repro_torch.core.events import FailStopEvent
    from repro_torch.core.world_pool import WorldPool
    from repro_torch.elastic import ControllerEndpoint, ElasticScheduler, WireEndpoint, choose_mode
    from repro_torch.elastic import protocol as pr
    from repro_torch.optim import AdamWConfig
    from repro_torch.reshard import OperatingPoint, WirePolicy

    cfg = get_config(TRAIN["arch"])
    opt = AdamWConfig(learning_rate=1e-4, warmup_steps=2, total_steps=1000)
    kw = dict(seq_len=TRAIN["seq"], global_batch=TRAIN["batch"], device=TRAIN["device"],
              devices=[TRAIN["device"]] * SCHEDULE["pool_ranks"])
    P = ParallelConfig
    DP2TP2, DP2TP4, DP1TP4, DP1TP2 = P(dp=2, tp=2), P(dp=2, tp=4), P(dp=1, tp=4), P(dp=1, tp=2)
    StepClock, Estimates = _schedule_endpoints()
    safety, k, inf = SCHEDULE["safety"], SCHEDULE["before"], float("inf")
    peaks: list[float] = []
    path: dict = {}

    def fresh(**extra):
        gc.collect()  # the last controller, whatever cycle holds it
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        return LiveRController(cfg, DP2TP2, opt, world_pool=WorldPool(capacity=2), **kw, **extra)

    def peak() -> float:
        peaks.append(torch.cuda.max_memory_allocated() / 1e9)
        return peaks[-1]

    def ending(ctrl) -> tuple:
        """The state's digest and the next losses."""
        digest = state_digest(ctrl)
        losses = ctrl.train_steps(SCHEDULE["after"])
        assert all(np.isfinite(losses)), losses
        return digest, losses

    # Part A: a stream, a retarget a step later that adopts its layers, a
    # duplicate of it, and a fail-stop of ranks 2 and 3 a step after that,
    # its target asked of the endpoint; then the same commands directly
    t0 = time.perf_counter()
    a = fresh(overlap="stream")
    trace = [ResizeEvent(k * STEP_CLOCK_S, DP2TP4, inf), ResizeEvent((k + 1) * STEP_CLOCK_S, DP1TP4, inf),
             ResizeEvent((k + 1) * STEP_CLOCK_S, DP1TP4, inf), FailStopEvent((k + 2) * STEP_CLOCK_S, lost_ranks=(2, 3))]
    _zero_counts()  # the schedule path's counts start here ...
    rep = ElasticScheduler(StepClock(WireEndpoint(ControllerEndpoint(a))), sync_prepare=True,
                           tail_steps=SCHEDULE["tail"]).run(trace)
    _take_counts(path)
    got = [(o.decision, o.outcome) for o in rep.outcomes]
    assert got == [("stream", "retargeted"), ("stream", "retargeted"), ("coalesce", "coalesced"),
                   ("peer_recover", "committed")], got
    assert [(r.mode, r.outcome) for r in a.records] == [
        ("live_overlap", "retargeted"), ("live_overlap", "retargeted"), ("peer_recover", "committed")], a.records
    adopted, recovered = a.records[1], a.records[2]
    assert adopted.reused_layers >= 1, a.records
    survivor = a.world.parallel
    ops = [OperatingPoint(**o.operating_point) for o in rep.outcomes[:2]]
    sched_end, sched_step, a_peak = ending(a), a.step, peak()
    log("schedule", f"A: {cfg.name} full width, batch {TRAIN['batch']} x {TRAIN['seq']}, {len(a.devices)} ranks, "
                    f"WorldPool(capacity=2), through ElasticScheduler -> WireEndpoint -> ControllerEndpoint "
                    f"(sync_prepare, a clock of a step each {STEP_CLOCK_S:.0f} trace s): "
                    + "; ".join(f"{o.kind} -> {o.target} {o.decision}/{o.outcome}" for o in rep.outcomes)
                    + f"; adopted {adopted.reused_layers} layers, recovered to {survivor.describe()} from "
                      f"{recovered.donors} donors ({recovered.executed_bytes / 1e9:.4f} GB, pause "
                      f"{recovered.total_pause_s:.4f} s); {rep.steps} steps, {time.perf_counter() - t0:.1f}s, "
                      f"peak {a_peak:.2f} GB")
    del a, adopted, recovered

    t0 = time.perf_counter()
    b = fresh(overlap="stream")
    for _ in range(k):
        b.train_steps(1)
    b.request_resize(DP2TP4, overlap="stream", operating_point=ops[0])
    b.wait_shadow_ready()
    b.train_steps(1)
    b.retarget_resize(DP1TP4, overlap="stream", operating_point=ops[1])
    b.wait_shadow_ready()
    b.train_steps(1)
    b.cancel_resize(outcome="retargeted")
    b.fail_stop_recover(survivor, devices_failed=True, lost_ranks=(2, 3))
    for _ in range(SCHEDULE["tail"]):
        b.train_steps(1)
    _zero_counts()  # the direct run is the comparison, not the path
    direct_end, direct_step = ending(b), b.step
    log("schedule", f"A: the same commands made directly in {time.perf_counter() - t0:.1f}s, peak {peak():.2f} GB: "
                    f"step {direct_step} against {sched_step}, the state's digest equal "
                    f"{direct_end[0] == sched_end[0]}, the next {SCHEDULE['after']} losses {direct_end[1]} against "
                    f"{sched_end[1]}")
    assert direct_step == sched_step and direct_end == sched_end, "the scheduler's run differs from the direct one"
    del b

    # Part B: the lattice on the card's own timings, the wall clock at
    # time scale 1, the int8 moment wire, the real estimator, prefetch on
    t0 = time.perf_counter()
    c = fresh(wire_policy=WirePolicy())
    ep = Estimates(WireEndpoint(ControllerEndpoint(c, prefetch_k=SCHEDULE["prefetch_k"])))
    _zero_counts()
    sched = ElasticScheduler(ep, time_scale=1.0, safety=safety, tail_steps=SCHEDULE["tail"])
    events: list[dict] = []

    def estimate(target):
        return ep.handle(pr.QueryEstimate(target=target)).estimate

    def run(scheduler, target, window, wanted):
        seen = len(ep.seen)
        records = len(c.records)
        report = scheduler.run([ResizeEvent(scheduler.clock, target, window)])
        out = report.outcomes[-1]
        used = ep.seen[seen] if len(ep.seen) > seen else None
        assert used is not None and len(c.records) == records + 1, (ep.seen[seen:], c.records[records:])
        events.append({"o": out, "est": used, "rec": c.records[-1], "override": scheduler.mode_override,
                       "report": report})
        assert out.decision_lossless, out
        if scheduler.mode_override is None:
            assert out.decision == choose_mode(used, out.window_s, safety, 1.0), (out, used)
            assert out.decision_lossless == choose_mode(used, out.window_s, safety, 1.0, lossless=True), out
        assert (out.decision, out.outcome) == wanted, (out, used)
        return used

    # 1. unbounded: a stream, which gives the estimator its history
    run(sched, DP2TP4, inf, ("stream", "committed"))
    # 2. a window between the two totals of the estimate read just before it
    est = estimate(DP2TP2)
    lo, hi = safety * est.stop_copy_total_s, safety * est.stream_total_s
    assert lo < hi, est
    run(sched, DP2TP2, (lo + hi) / 2, ("stop_copy", "committed"))
    # 3. no window, the peers cover the state
    assert estimate(DP1TP2).peer_ok
    run(sched, DP1TP2, 0.0, ("peer_recover", "committed"))
    # 4. a stream forced on a window that fits only stop-copy, near its
    # lower end: escalated. Its Prepare is waited for (sync_prepare), so that
    # the escalation finds the shadow ready and the window's end, with the
    # peers' rung beneath it, does not come first
    est = estimate(DP1TP4)
    lo, hi = safety * est.stop_copy_total_s, safety * est.stream_total_s
    window = lo + 0.1 * (hi - lo)
    assert choose_mode(est, window, safety, 1.0) == "stop_copy", est
    forced = ElasticScheduler(ep, time_scale=1.0, safety=safety, tail_steps=SCHEDULE["tail"], mode_override="stream",
                              sync_prepare=True)
    used = run(forced, DP1TP4, window, ("stream", "fell_back"))
    assert choose_mode(used, window, safety, 1.0) == "stop_copy", used
    _take_counts(path)  # ... and are read here
    b_peak = peak()
    report = events[-1]["report"]  # the endpoint's ledger over the whole of Part B
    escalations = sum(e["rec"].outcome == "fell_back" and e["rec"].mode != "fallback" for e in events)
    peer = sum(e["rec"].mode == "peer_recover" for e in events)
    assert (escalations, peer) == (1, 1), [(e["rec"].mode, e["rec"].outcome) for e in events]
    for i, e in enumerate(events):
        o, est, rec = e["o"], e["est"], e["rec"]
        pause_est = {"stream": est.stream_pause_s, "stop_copy": est.stop_copy_pause_s,
                     "peer_recover": est.peer_pause_s}[o.decision]
        if rec.outcome == "fell_back":
            pause_est = est.stop_copy_pause_s  # the escalation commits by stop-copy
        log("schedule", f"B{i + 1}: {rec.src} -> {rec.dst}, window {o.window_s:.4f} s, decision {o.decision}"
                        + (f" (mode_override; choose_mode gives {choose_mode(est, o.window_s, safety, 1.0)})"
                           if e["override"] else "")
                        + f", decision_lossless {o.decision_lossless}, outcome {o.outcome} ({rec.mode}); "
                          f"prepare_s est {est.prepare_s:.4f} ({'warm' if est.warm else 'cold'}) measured "
                          f"{rec.prepare_s:.4f} [{rec.prepare_source}]; pause est {pause_est:.4f} measured "
                          f"{o.pause_s:.4f} s; est totals stream {est.stream_total_s:.4f} stop-copy "
                          f"{est.stop_copy_total_s:.4f} s (rounds {est.rounds}, step {est.step_s:.4f} s, wire "
                          f"{est.wire_bytes / 1e9:.4f} GB at {est.measured_bw / 1e9:.2f} GB/s measured); "
                          f"met_deadline {o.met_deadline} (trigger to commit "
                          f"{o.commit_clock_s - o.time_s:.4f} s on the trace clock); operating point "
                          f"{o.operating_point}")
    log("schedule", f"B: {len(events)} events in {time.perf_counter() - t0:.1f}s, {sched.total_steps + forced.total_steps} "
                    f"steps; ScheduleReport goodput {report.goodput:.6f}, pause_seconds {report.pause_seconds:.4f}; "
                    f"speculative builds started by PrefetchPolicy {ep.prefetch.started}, pool "
                    f"{c.world_pool.stats.to_dict()}; peak {b_peak:.2f} GB")
    del c, ep, events, report
    gc.collect()
    torch.cuda.empty_cache()
    phase_peak = max(peaks)
    log("schedule", f"peak memory {phase_peak:.2f} GB (train phase {train_peak_gb:.2f} GB); launches {path}")
    assert phase_peak <= TOL_PEAK * train_peak_gb, f"peak {phase_peak:.2f} GB: a second set of the state?"
    for name in ("flash_attention", "flash_attention_bwd", "pack_rows", "scatter_rows", "pack_quant_rows",
                 "dequant_scatter_rows"):
        assert path[name] > 0, f"{name} was not launched on the schedule path"
    return path


def _record(name, source, replaces, launches, err, ms, plain_ms, bound_ms, bound_by, library_ms, **extra) -> dict:
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": launches,
            "max_abs_err": err, "max_err": err, "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms, **extra}


def _bwd_times(shape) -> dict:
    """The backward kernel at ``shape`` (bf16), beside the CUDA-core route,
    the plain version's backward and ``scaled_dot_product_attention``'s
    backward, each timed alone on graphs kept for reuse."""
    b, s, t, h, kh, d, causal, window = shape
    q, k, v = rand_qkv(shape, torch.bfloat16, seed=7)
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
    flops, nbytes = work.flash_bwd_bound(b, s, t, h, kh, d, causal, window, q.element_size())
    bytes_ms, flops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOP_PER_S * 1e3
    bound_ms = max(bytes_ms, flops_ms)
    tflops = flops / kernel_ms / 1e9  # the 5 products' FLOPs: the kernel does 7
    log("times", f"flash_attention backward {shape} bf16: kernel {kernel_ms:.4f} ms ({tflops:.1f} TFLOP/s of "
                 f"the 5 products; its three kernels on the device {on_device_ms:.4f} ms), the CUDA-core route "
                 f"{cuda_cores_ms:.4f} ms, plain backward {plain_ms:.4f} ms, sdpa backward {library_ms:.4f} ms "
                 f"(on the device {library_device_ms:.4f} ms), bound {bound_ms:.4f} ms "
                 f"({nbytes / 1e6:.1f} MB -> {bytes_ms:.4f} ms; {flops / 1e9:.2f} GFLOP -> {flops_ms:.4f} ms)")
    return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations", "library_ms": library_ms,
            "device_ms": on_device_ms, "library_device_ms": library_device_ms, "tflops": tflops,
            "cuda_cores_ms": cuda_cores_ms, "shape": list(shape)}


def phase_bwd_times(launches: int, case_err: float) -> dict:
    """The backward at the training shape (the record's numbers) and at
    seamless's encoder training shape (non-causal, heads of 64; kept in
    the record beside them)."""
    train, enc = _bwd_times(TRAIN_SHAPE), _bwd_times(ENC_TRAIN_SHAPE)
    return _record("flash_attention_bwd", "src/repro_torch/kernels/csrc/flash_attention_bwd_tc.cu",
                   "src/repro/kernels/flash_attention.py:124 (backward; the TPU kernel has none)", launches,
                   case_err, train["ms"], train["plain_ms"], train["bound_ms"], train["bound_by"],
                   train["library_ms"], device_ms=train["device_ms"], library_device_ms=train["library_device_ms"],
                   tflops=train["tflops"], cuda_cores_ms=train["cuda_cores_ms"],
                   sources={"tensor_cores": "src/repro_torch/kernels/csrc/flash_attention_bwd_tc.cu",
                            "cuda_cores": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"},
                   shape=train["shape"], encoder_shape=enc,
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
    with dt = 0) against the plain scan (its gradients: phase_ssd_bwd_cases).
    Returns the worst error at the serving shape."""
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
    docstring, 20."""
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
    """The TF32 tensor-core FLOPs the SSD kernel issues on this card
    (``work.ssd_tensor_core_flops`` at its SM count)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return work.ssd_tensor_core_flops(*case, x_dtype == torch.bfloat16, sms=sms)


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
    # each input read once, each output written once; the least f32 work:
    # C.B^T and M.x over the causal half of each chunk (C.B^T once per batch
    # row and chunk), and the chunk state over all of it
    nbytes = work.ssd_fwd_bytes(*SSD_SERVE_SHAPE, x.element_size())
    flops = work.ssd_fwd_flops(*SSD_SERVE_SHAPE)
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
        nbytes = work.rmsnorm_bytes(rows, d, x.element_size(), sc.element_size())
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


# ---------------------------------------------------------------------------
# Slice 13: the SSD backward kernel; training and live-resizing mamba2-2.7b
# ---------------------------------------------------------------------------

# the training path's SSD block: batch 4 x 1024 tokens, 80 heads of 64,
# state 128, chunk 64
SSD_TRAIN_SHAPE = (4, 1024, 80, 64, 128, 64)
SSD_BWD_NAMES = ("dx", "ddt", "dcum", "dB", "dC")
# the backward's f32 outputs against the plain backward, relative to the
# largest |plain| value: f32 sums in another order. The plain backward in
# f32 is within 5.1e-7 of the same in f64 on these shapes and spans
# (tests/test_torch_ssd_bwd.py), so the forward's SSD_TOL leaves a margin of
# ~40. A bf16 dx is rounded from f32 sums that differ in their last bits:
# within one bf16 step at its magnitude plus that f32 bound (where a sum
# cancels to near 0, the f32 error exceeds the value's own step).
SSD_BWD_TOL = SSD_TOL
# the mean span |sum dt*A| of a chunk in the overflow cases: A is scaled so
# that exp(cum_t - cum_s) above the diagonal (s > t) overflows f32 (~88)
SSD_SPAN = 150.0
# ops.ssd_scan's gradients: mamba2's head dim and state on a ragged sequence
SSD_SCAN_CASE = (2, 300, 8, 64, 128, 64)
MAMBA_TRAIN = dict(arch="mamba2-2.7b", batch=4, seq=1024, steps=4)
# the first step's gradients, the kernels against SSDIntraChunkRef on the
# same glue, leaf by leaf as ||g - g_plain|| / ||g_plain||. In f32 compute
# at full width and depth: within MAMBA_GRAD_TOL (the kernels measured
# 1.6e-5 to 1.8e-5, and one f32 ulp of noise on the plain block's outputs
# 1.4e-5 to 1.5e-5, on an H100 80GB HBM3 at 700 W). In bf16 compute (the
# run's) any f32 rounding of y_intra flips bf16 roundings of the activations, which 64 layers carry to
# ~7% of every gradient (both measured 2.6e-2 to 7.9e-2): there the kernels
# may move a leaf at most MAMBA_NOISE_RATIO times as far as that one-ulp
# noise does (measured 0.97-1.07x)
MAMBA_GRAD_TOL = 1e-4
MAMBA_NOISE_RATIO = 2.0
# the elastic phase: 48 of mamba2's 64 layers (the cut is its docstring's)
MAMBA_ELASTIC = dict(layers=48, before=2, after=2, stream_k=8)


def ssd_bwd_inputs(case, dtype, seed, span=None):
    """``ssd_inputs`` with A scaled so that a chunk's mean span is ``span``
    (None: as drawn), and the output gradients dy, dS: x, dt, A, B, C, cum,
    dy, dS on the card."""
    b, s, h, p, n, chunk = case
    x, dt, A, B, C, cum = ssd_inputs(case, dtype, seed)
    if span is not None:
        A = A * (span / (-cum.reshape(b, s // chunk, chunk, h)[:, :, -1]).mean())
        cum = torch.cumsum(dt.reshape(b, s // chunk, chunk, h) * A, dim=2).reshape(b, s, h)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    dy = torch.randn(b, s, h, p, generator=g, device="cuda")
    dS = torch.randn(b, s // chunk, h, p, n, generator=g, device="cuda")
    return x, dt, A, B, C, cum, dy, dS


def _bf16_units(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over one bf16 step at want's magnitude plus
    SSD_BWD_TOL of max |want|."""
    w = want.float()
    step = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(2.0**-126))) - 7)
    return ((got.float() - w).abs() / (step + SSD_BWD_TOL * w.abs().max())).max().item()


def _grad_errors(names, got, want) -> dict:
    """Each gradient's error against the plain one, in units of its
    tolerance: max |error| / max |plain| over SSD_BWD_TOL in f32, ``_bf16_units``
    in bf16."""
    out = {}
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, (name, g.shape, g.dtype, w.shape, w.dtype)
        assert torch.isfinite(g.float()).all(), f"SSD backward: {name} is not finite"
        assert torch.isfinite(w.float()).all(), f"the plain SSD backward: {name} is not finite"
        if g.dtype == torch.bfloat16:
            out[name] = _bf16_units(g, w)
        else:
            out[name] = (g - w).abs().max().item() / w.abs().max().item() / SSD_BWD_TOL
    return out


def ssd_bwd_vs_plain(x, dt, cum, B, C, dy, dS, chunk) -> dict:
    """The backward kernel against the plain backward on the same inputs:
    every output finite, of the plain version's shape and dtype, the same
    bits in a second launch; each output's error in units of its tolerance
    (``_grad_errors``)."""
    before = ssd_k.bwd_launches
    got = ssd_k.ssd_intra_chunk_bwd_cuda(x, dt, cum, B, C, dy, dS, chunk)
    again = ssd_k.ssd_intra_chunk_bwd_cuda(x, dt, cum, B, C, dy, dS, chunk)
    want = R.ssd_intra_chunk_bwd_ref(x, dt, cum, B, C, dy, dS, chunk)
    torch.cuda.synchronize()
    assert ssd_k.bwd_launches == before + 2, "a backward call is not one counted launch"
    for name, g, a in zip(SSD_BWD_NAMES, got, again):
        assert torch.equal(_bytes(g), _bytes(a)), f"SSD backward: {name} differs between two launches"
    return _grad_errors(SSD_BWD_NAMES, got, want)


def phase_ssd_bwd_cases() -> float:
    """The SSD backward kernel against the plain backward (TF32 off), every
    case in x f32 and bf16, at the spans drawn and past exp's overflow: the
    JAX kernel tests' shapes, reduced mamba2's chunk 8 and state 16, the
    training shape; ``ops.ssd_scan`` on a ragged sequence with an initial
    state, every input's gradient against the same glue around
    ``SSDIntraChunkRef``; each bad argument refused. Returns the worst f32
    error at the training shape (max |error| / max |plain|)."""
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for i, case in enumerate(SSD_CASES + [SSD_TRAIN_SHAPE]):
            b, s, h, p, n, chunk = case
            for span in (None, SSD_SPAN):
                x, dt, A, B, C, cum, dy, dS = ssd_bwd_inputs(case, dtype, 300 + i, span)
                reach = (-cum.reshape(b, s // chunk, chunk, h)[:, :, -1]).max().item()
                errs = ssd_bwd_vs_plain(x, dt, cum, B, C, dy, dS, chunk)
                log("ssd-bwd", f"ssd_intra_chunk_bwd {case} x {str(dtype)[6:]}, largest chunk span {reach:.1f}: "
                               + ", ".join(f"{k} {v:.3f}" for k, v in errs.items())
                               + f" of the tolerance ({SSD_BWD_TOL:g} of max |plain|; a bf16 dx one bf16 step more); "
                                 "finite; a second launch bitwise equal")
                assert max(errs.values()) <= 1.0, f"SSD backward disagrees with the plain backward on {case}"
                if span is not None:
                    assert reach > 88, f"the overflow case's span {reach} does not pass 88"
                if case == SSD_TRAIN_SHAPE:
                    worst = max(worst, max(v for k, v in errs.items() if k != "dx" or dtype == torch.float32))
                del x, dt, A, B, C, cum, dy, dS
    b, s, h, p, n, chunk = SSD_SCAN_CASE
    for dtype in (torch.float32, torch.bfloat16):
        x, dt, A, B, C, _, _, _ = ssd_bwd_inputs((b, s + (-s) % chunk, h, p, n, chunk), dtype, 400)
        x, dt, B, C = (t[:, :s].contiguous() for t in (x, dt, B, C))
        g = torch.Generator(device="cuda").manual_seed(401)
        h0 = torch.randn(b, h, p, n, generator=g, device="cuda")
        gy = torch.randn(b, s, h, p, generator=g, device="cuda")
        gf = torch.randn(b, h, p, n, generator=g, device="cuda")
        leaves = (x, dt, A, B, C, h0)

        def grads(scan):
            ins = [t.detach().clone().requires_grad_(True) for t in leaves]
            y, final = scan(*ins)
            return y.detach(), final.detach(), torch.autograd.grad((y, final), ins, (gy, gf))

        before = (ssd_k.launches, ssd_k.bwd_launches)
        yk, fk, gk = grads(lambda x, dt, A, B, C, h0: ops.ssd_scan(x, dt, A, B, C, chunk, init_state=h0))
        yp, fp, gp = grads(lambda x, dt, A, B, C, h0: ops.ssd_scan_chunked(
            x, dt, A, B, C, chunk, h0, R.SSDIntraChunkRef.apply))
        torch.cuda.synchronize()
        assert (ssd_k.launches, ssd_k.bwd_launches) == (before[0] + 1, before[1] + 1), "not one launch of each"
        errs = {"y": (yk - yp).abs().max().item() / yp.abs().max().item() / SSD_TOL,
                "final": (fk - fp).abs().max().item() / fp.abs().max().item() / SSD_TOL}
        errs.update(_grad_errors(("dx", "ddt", "dA", "dB", "dC", "dinit_state"), gk, gp))
        log("ssd-bwd", f"ops.ssd_scan {SSD_SCAN_CASE[:5]}, ragged s {s} of chunk {chunk}, x {str(dtype)[6:]}, "
                       "a nonzero initial state, against ssd_scan_chunked around SSDIntraChunkRef: "
                       + ", ".join(f"{k} {v:.3f}" for k, v in errs.items()) + " of the tolerance")
        assert max(errs.values()) <= 1.0, f"ops.ssd_scan's gradients disagree with the plain glue's ({dtype})"
    x, dt, A, B, C, cum, dy, dS = ssd_bwd_inputs(SSD_CASES[1], torch.float32, 1)
    chunk = SSD_CASES[1][-1]
    bwd = ssd_k.ssd_intra_chunk_bwd_cuda
    before = ssd_k.bwd_launches
    for why, call in {
        "dy of the wrong shape": lambda: bwd(x, dt, cum, B, C, dy[:, :64].contiguous(), dS, chunk),
        "dS in bf16": lambda: bwd(x, dt, cum, B, C, dy, dS.bfloat16(), chunk),
        "a dy that is not contiguous": lambda: bwd(x, dt, cum, B, C, dy.transpose(1, 2).contiguous().transpose(1, 2),
                                                   dS, chunk),
        "dS on the CPU": lambda: bwd(x, dt, cum, B, C, dy, dS.cpu(), chunk),
        "x in float16": lambda: bwd(x.half(), dt, cum, B, C, dy, dS, chunk),
        "chunk 128": lambda: bwd(x, dt, cum, B, C, dy, dS, 128),
        "a sequence not a multiple of the chunk": lambda: bwd(*(t[:, :120].contiguous() for t in (x, dt, cum, B, C, dy)),
                                                              dS, chunk),
    }.items():
        try:
            call()
        except ValueError:
            log("ssd-bwd", f"refused {why}")
        else:
            raise AssertionError(f"SSD backward accepted {why}")
    assert ssd_k.bwd_launches == before, "a refused call launched"
    return worst


def ssd_bwd_flops(case) -> int:
    """The least f32 work of the SSD backward (``work.ssd_bwd_flops``)."""
    return work.ssd_bwd_flops(*case)


def ssd_bwd_tensor_core_flops(case, x_dtype) -> int:
    """The TF32 tensor-core FLOPs the SSD backward issues on this card
    (``work.ssd_bwd_tensor_core_flops`` at its SM count)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return work.ssd_bwd_tensor_core_flops(*case, x_dtype == torch.bfloat16, sms=sms)


def phase_ssd_bwd_times(launches: int, err: float) -> dict:
    """The SSD backward at the training shape (x bf16): the call (CUDA
    events, median of 30) and its two kernels alone on the device (the
    profiler), beside the plain backward, autograd of the plain forward and
    the card's bound. No single PyTorch call computes it."""
    b, s, h, p, n, chunk = SSD_TRAIN_SHAPE
    x, dt, A, B, C, cum, dy, dS = ssd_bwd_inputs(SSD_TRAIN_SHAPE, torch.bfloat16, seed=98)
    case_err = max(v for k, v in ssd_bwd_vs_plain(x, dt, cum, B, C, dy, dS, chunk).items() if k != "dx")
    kernel = lambda: ssd_k.ssd_intra_chunk_bwd_cuda(x, dt, cum, B, C, dy, dS, chunk)  # noqa: E731
    kernel_ms = median_ms(kernel)
    on_device_ms = device_ms(kernel, ("ssd_intra_chunk_bwd_kernel", "sum_groups_kernel"),
                             per_call=lambda: ssd_k.bwd_launches)
    plain_ms = median_ms(lambda: R.ssd_intra_chunk_bwd_ref(x, dt, cum, B, C, dy, dS, chunk))
    ins = [t.detach().clone().requires_grad_(True) for t in (x, dt, cum, B, C)]
    y, S = R.ssd_intra_chunk_ref(*ins, chunk)
    autograd_ms = median_ms(lambda: torch.autograd.grad((y, S), ins, (dy, dS), retain_graph=True))
    del y, S, ins
    # each input read once, each output written once
    nbytes = work.ssd_bwd_bytes(*SSD_TRAIN_SHAPE, x.element_size())
    flops = ssd_bwd_flops(SSD_TRAIN_SHAPE)
    bytes_ms, flops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
    # the card's fastest f32-accurate products are on the tensor cores, three
    # TF32 products each (the 3xTF32 split both kernels use): the least time
    # is the larger of the bytes and that; the CUDA cores' f32 bound is
    # reported beside it
    tc_ms = 3 * flops / TF32_FLOP_PER_S * 1e3
    bound_ms = max(bytes_ms, tc_ms)
    log("times", f"ssd_intra_chunk_bwd {SSD_TRAIN_SHAPE} x bf16: kernel {kernel_ms:.4f} ms (its two kernels on the "
                 f"device {on_device_ms:.4f} ms, {flops / on_device_ms / 1e9:.2f} TFLOP/s of the least f32 work), "
                 f"plain backward {plain_ms:.4f} ms, autograd of the plain forward {autograd_ms:.4f} ms, library "
                 f"none, bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB -> {bytes_ms:.4f} ms; {flops / 1e9:.2f} "
                 f"GFLOP f32 as 3xTF32 on the tensor cores -> {tc_ms:.4f} ms, on the CUDA cores -> "
                 f"{flops_ms:.4f} ms), worst f32 error {case_err:.3f} of the tolerance")
    return _record("ssd_intra_chunk_bwd", "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
                   "src/repro/kernels/ssd_scan.py:86 (backward; the TPU kernel has none)", launches,
                   max(err, case_err) * SSD_BWD_TOL, kernel_ms, plain_ms, bound_ms,
                   "bytes" if bytes_ms >= tc_ms else "operations", None, device_ms=on_device_ms,
                   autograd_ms=autograd_ms, bytes_bound_ms=bytes_ms, tensor_core_bound_ms=tc_ms,
                   f32_cuda_core_bound_ms=flops_ms,
                   shape=list(SSD_TRAIN_SHAPE),
                   err_is="max |error| / max |plain| over ddt, dcum, dB and dC (and dx in f32), the cases at the "
                          "training shape and the timed inputs")


class _OneUlp(torch.autograd.Function):
    """The plain block whose outputs carry one f32 ulp of seeded noise
    (each element times 1 + k 2^-23, k in {-1, 0, 1}), with the plain
    backward: how far rounding alone moves what comes after the block."""

    @staticmethod
    def forward(ctx, x, dt, cum, B, C, chunk: int):
        ctx.save_for_backward(x, dt, cum, B, C)
        ctx.chunk = chunk
        g = torch.Generator(device=x.device).manual_seed(17)
        return tuple(t * (1 + (torch.randint(0, 3, t.shape, generator=g, device=t.device) - 1) * 2.0**-23)
                     for t in R.ssd_intra_chunk_ref(x, dt, cum, B, C, chunk))

    @staticmethod
    def backward(ctx, dy, dS):
        x, dt, cum, B, C = ctx.saved_tensors
        return (*R.ssd_intra_chunk_bwd_ref(x, dt, cum, B, C, dy, dS, ctx.chunk), None)


def _grads_against_plain(grad_fn, params, batch, noise: bool = False) -> dict:
    """``grad_fn``'s gradients through the kernels (and, with ``noise``,
    through ``_OneUlp``), each leaf against the same through
    ``SSDIntraChunkRef``: {"kernels": {path: ||g - g_plain|| / ||g_plain||},
    "one ulp": ...}. One other set of gradients is held at a time."""
    from repro_torch.utils.pytree import tree_paths

    orig = ssd_k.ssd_intra_chunk

    def grads(intra):
        ssd_k.ssd_intra_chunk = intra
        try:
            return tree_paths(grad_fn(params, batch)[2])
        finally:
            ssd_k.ssd_intra_chunk = orig

    plain = grads(R.SSDIntraChunkRef.apply)
    out = {}
    for name, intra in [("kernels", orig)] + ([("one ulp", _OneUlp.apply)] if noise else []):
        got = grads(intra)
        assert all(torch.isfinite(g).all() for g in got.values()), f"{name}: a gradient is not finite"
        out[name] = {p: ((g - plain[p]).norm() / plain[p].norm()).item() for p, g in got.items()}
        del got
    return out


def _mamba_opt():
    from repro_torch.optim import AdamWConfig

    return AdamWConfig(learning_rate=1e-4, warmup_steps=2, total_steps=1000)


def phase_train_mamba2() -> tuple[dict, float]:
    """mamba2-2.7b trained at full width and depth (see the module
    docstring, 26). Returns the launches of the path and the peak memory."""
    import gc

    from repro_torch.core.controller import LiveRController
    from repro_torch.distribution.step import make_grad_fn

    cfg = get_config(MAMBA_TRAIN["arch"])
    kw = dict(seq_len=MAMBA_TRAIN["seq"], global_batch=MAMBA_TRAIN["batch"], device="cuda")
    steps, layers = MAMBA_TRAIN["steps"], cfg.num_layers
    gc.collect()
    torch.cuda.empty_cache()
    # a first step's gradients in f32 compute (the run's init, a seeded
    # batch), the kernels against the plain block with its written-out backward
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = M.init_params(cfg32, torch.Generator(device="cuda").manual_seed(0), "cuda")
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (MAMBA_TRAIN["batch"], MAMBA_TRAIN["seq"]),
                                     generator=torch.Generator().manual_seed(0)).to("cuda")}
    rel32 = _grads_against_plain(make_grad_fn(cfg32), params, batch)["kernels"]
    del params
    worst32 = max(rel32.values())
    log("train-ssm", f"first step's gradients in f32 compute, the kernels against SSDIntraChunkRef (plain forward and "
                     f"backward on the card): {len(rel32)} leaves, ||g - g_plain|| / ||g_plain|| at most "
                     f"{worst32:.3e} (tol {MAMBA_GRAD_TOL:g}; {max(rel32, key=rel32.get)})")
    assert worst32 <= MAMBA_GRAD_TOL, "the kernels' f32 gradients disagree with the plain block's"

    ctrl = LiveRController(cfg, ParallelConfig(dp=2, tp=2), _mamba_opt(), **kw)
    # the run's first step (bf16 compute): the kernels and one f32 ulp of
    # noise on the plain block's outputs, each against the plain block
    batch = {"tokens": torch.from_numpy(ctrl.data.global_batch_at(ctrl.step)).to("cuda", torch.long)}
    rel = _grads_against_plain(ctrl.world.grad_fn, ctrl.params, batch, noise=True)
    del batch
    ratio = {p: rel["kernels"][p] / rel["one ulp"][p] for p in rel["kernels"]}
    log("train-ssm", f"the run's first step's gradients (bf16 compute), against SSDIntraChunkRef: the kernels "
                     f"{min(rel['kernels'].values()):.3e} to {max(rel['kernels'].values()):.3e}, one f32 ulp of "
                     f"noise on the plain block's outputs {min(rel['one ulp'].values()):.3e} to "
                     f"{max(rel['one ulp'].values()):.3e}; the kernels over the noise {min(ratio.values()):.3f} to "
                     f"{max(ratio.values()):.3f}x (at most {MAMBA_NOISE_RATIO:g}x)")
    assert max(ratio.values()) <= MAMBA_NOISE_RATIO, "the kernels move the bf16 gradients more than f32 noise does"

    def run(controller) -> tuple[list, dict, dict]:
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()  # the training path's counts start here ...
        losses = controller.train_steps(steps)
        launches = _all_counts()  # ... and are read here
        return losses, launches, state_digest(controller)

    losses, launches, digest = run(ctrl)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    times = ctrl.iteration_times[1:]  # the first step warms up
    step_s = statistics.median(times)
    log("train-ssm", f"{cfg.name} full width and depth ({layers} SSD layers, d_model {cfg.d_model}, fp32 params, "
                     f"{cfg.dtype} compute, AdamW, remat per layer), batch {MAMBA_TRAIN['batch']} x "
                     f"{MAMBA_TRAIN['seq']} on dp2tp2: losses {losses}, median step {step_s:.4f} s over steps 2-{steps} "
                     f"({MAMBA_TRAIN['batch'] * MAMBA_TRAIN['seq'] / step_s:.0f} tokens/s; {[round(t, 4) for t in times]}), "
                     f"peak memory {peak_gb:.2f} GB, SSD launches {launches['ssd_intra_chunk']} forward / "
                     f"{launches['ssd_intra_chunk_bwd']} backward")
    assert all(np.isfinite(losses)), "a loss is not finite"
    assert launches["ssd_intra_chunk"] == 2 * layers * steps, launches
    assert launches["ssd_intra_chunk_bwd"] == layers * steps, launches
    assert launches["flash_attention"] == 0, launches

    # where a step's time goes: one more step, its halves apart, under the
    # profiler (after the digest: it changes the state)
    def ssd_class(name: str) -> str:
        if "ssd_intra_chunk_bwd_kernel" in name or "sum_groups_kernel" in name:
            return "ssd backward"
        return "ssd forward" if "ssd_intra_chunk_kernel" in name else _kernel_class(name)

    log_step_profile("train-ssm", "one step", profile_step(ctrl.world, ctrl.params, ctrl.opt_state, ctrl._batch(),
                                                           ssd_class), share_of="ssd backward")
    del ctrl
    gc.collect()
    torch.cuda.empty_cache()

    # a second run from the same seed: the same losses and state, bit for bit
    again = LiveRController(cfg, ParallelConfig(dp=2, tp=2), _mamba_opt(), **kw)
    a_losses, a_launches, a_digest = run(again)
    log("train-ssm", f"a second run from seed 0: losses bitwise equal {a_losses == losses}, the state's digest "
                     f"({len(digest)} tensors) equal {a_digest == digest}")
    assert a_losses == losses and a_digest == digest and a_launches == launches, "a second run differs"
    del again
    gc.collect()
    torch.cuda.empty_cache()
    return launches, peak_gb


def phase_elastic_train_mamba2() -> dict:
    """Live-resized mamba2 training at full width, at 48 of its 64 layers
    (see the module docstring, 27): the JAX package's scale-in dp2tp2 ->
    dp1tp2 by stop-copy, then dp1tp2 -> dp2tp2 streamed with the split-step
    commit, lossless, against a control run never resized. The depth is cut
    because a resize may hold the target world's params and moments beside
    the source's: at 64 layers that is ~79 GB with the gradients, past the
    card's 80 GB. Returns the launches of the path."""
    import gc

    from repro_torch.core.controller import LiveRController

    cfg = dataclasses.replace(get_config(MAMBA_TRAIN["arch"]), num_layers=MAMBA_ELASTIC["layers"])
    kw = dict(seq_len=MAMBA_TRAIN["seq"], global_batch=MAMBA_TRAIN["batch"], device="cuda")
    SRC, DST = ParallelConfig(dp=2, tp=2), ParallelConfig(dp=1, tp=2)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ctrl = LiveRController(cfg, SRC, _mamba_opt(), stream_k=MAMBA_ELASTIC["stream_k"], **kw)
    _zero_counts()  # the elastic path's counts start here ...
    t_run = time.perf_counter()
    losses = ctrl.train_steps(MAMBA_ELASTIC["before"])
    cuts = []
    for target, overlap in ((DST, "stop_copy"), (SRC, "stream")):
        ctrl.request_resize(target, overlap=overlap)
        n = len(ctrl.records)
        while len(ctrl.records) == n:
            losses += ctrl.train_steps(1)
            assert len(losses) < 60, f"the {overlap} resize to {target.describe()} never committed"
        cuts.append(len(losses))
    losses += ctrl.train_steps(MAMBA_ELASTIC["after"])
    run_s = time.perf_counter() - t_run
    launches = _all_counts()  # ... and are read here
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    digest = state_digest(ctrl)
    history = [s for s, _ in ctrl.machine.history]
    records = list(ctrl.records)
    layers = cfg.num_layers
    log("elastic-train-ssm", f"{cfg.name} at {layers} of 64 layers, full width, batch {MAMBA_TRAIN['batch']} x "
                             f"{MAMBA_TRAIN['seq']}, lossless: {SRC.describe()} -> {DST.describe()} (stop-copy) -> "
                             f"{SRC.describe()} (stream, stream_k {MAMBA_ELASTIC['stream_k']}): {len(losses)} steps in "
                             f"{run_s:.1f}s, commits after steps {cuts}, losses {losses}, peak memory {peak_gb:.2f} GB, "
                             f"SSD launches {launches['ssd_intra_chunk']} forward / "
                             f"{launches['ssd_intra_chunk_bwd']} backward")
    for i, rec in enumerate(records):
        log("elastic-train-ssm", f"commit {i + 1} {rec.mode} {rec.src} -> {rec.dst}: pause_s {rec.total_pause_s:.4f}, "
                                 f"prepare_s {rec.prepare_s:.4f}, logical {rec.logical_bytes / 1e9:.4f} GB, wire "
                                 f"{rec.wire_bytes / 1e9:.4f} GB, executed {rec.executed_bytes / 1e9:.4f} GB")
    assert [(r.mode, r.dst, r.outcome) for r in records] == [
        ("live", DST.describe(), "committed"), ("live_overlap", SRC.describe(), "committed")], records
    for phase in ("prepare", "ready", "switch", "cleanup", "stable"):
        assert phase in history, f"the machine never passed through {phase}: {history}"
    assert all(np.isfinite(losses)), "a loss is not finite"
    assert launches["ssd_intra_chunk"] == 2 * layers * len(losses), launches
    assert launches["ssd_intra_chunk_bwd"] == layers * len(losses), launches
    del ctrl
    gc.collect()
    torch.cuda.empty_cache()
    control = LiveRController(cfg, SRC, _mamba_opt(), **kw)
    c_losses = control.train_steps(len(losses))
    c_digest = state_digest(control)
    log("elastic-train-ssm", f"against a control run never resized: losses bitwise equal {c_losses == losses} "
                             f"(after the commits: {losses[cuts[0]:]}), the state's digest equal {c_digest == digest}; "
                             f"the machine passed through {sorted(set(history))}")
    assert c_losses == losses, "the resized run's losses differ from the control run's"
    assert c_digest == digest, "the resized run's state differs from the control run's"
    del control
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_calibrate() -> dict:
    """``sim/calibrate.measure`` on the card, into a temporary cache."""
    import tempfile

    from repro_torch.sim import calibrate

    with tempfile.TemporaryDirectory() as tmp:
        consts = calibrate.measure(force=True, cache=str(Path(tmp) / "calibration_torch.json"))
    log("calibrate", f"on {consts['device']}: " + ", ".join(f"{k} {consts[k]:.6g}" for k in calibrate.KEYS))
    assert consts["device"] == torch.cuda.get_device_name(0)
    assert all(consts[k] > 0 for k in calibrate.KEYS), consts
    return consts


# seamless-m4t-large-v2 trained as qwen3 in TRAIN: batch 4 x 1024 tokens
# with frames (4, 1024, 1024) from data.SyntheticFrames
SEAMLESS_TRAIN = dict(batch=4, seq=1024, before=3, after=3, stream_k=8)
# the first step's f32 gradients through the kernels against the plain
# attention's: per leaf, max |g - g_plain| / max |g_plain|
SEAMLESS_GRAD_TOL = 1e-4


def _grads_vs_plain_attention(grad_fn, params, batch) -> tuple[dict, tuple[int, int]]:
    """``grad_fn``'s gradients through the flash kernels against the same
    step with ``ops.flash_attention`` replaced by the plain version (under
    autograd on the card): {path: (max |g - g_plain| / max |g_plain|,
    ||g - g_plain|| / ||g_plain||)}, and the flash forward and backward
    launches of the kernels' step."""
    from repro_torch.utils.pytree import tree_paths

    orig = ops.flash_attention
    ops.flash_attention = flash_attention_ref
    try:
        plain = tree_paths(grad_fn(params, batch)[2])
    finally:
        ops.flash_attention = orig
    before = (fa.launches, fa.bwd_launches)
    got = tree_paths(grad_fn(params, batch)[2])
    launched = (fa.launches - before[0], fa.bwd_launches - before[1])
    out = {}
    for p, g in got.items():
        assert torch.isfinite(g).all(), f"{p}: a gradient is not finite"
        w = plain[p]
        out[p] = (((g - w).abs().max() / w.abs().max()).item(), ((g - w).norm() / w.norm()).item())
    return out, launched


def phase_train_encdec() -> dict:
    """seamless-m4t-large-v2 trained and live-resized at full width and
    depth (see the module docstring, 31). Returns the launches of the
    path."""
    import gc

    from repro_torch.core import controller as C
    from repro_torch.core.controller import LiveRController
    from repro_torch.data import SyntheticFrames
    from repro_torch.distribution.step import make_grad_fn
    from repro_torch.optim import AdamWConfig
    from repro_torch.reshard import WirePolicy
    from repro_torch.utils.pytree import tree_paths

    cfg = get_config(SEAMLESS)
    layers = cfg.encoder_layers + cfg.num_layers
    B, S = SEAMLESS_TRAIN["batch"], SEAMLESS_TRAIN["seq"]
    data = SyntheticFrames(cfg.vocab_size, S, B, cfg.d_model)
    gc.collect()
    torch.cuda.empty_cache()
    # the run's first step (its init, tokens and frames) in f32 compute:
    # the kernels against the plain attention
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = M.init_params(cfg32, torch.Generator(device="cuda").manual_seed(0), "cuda")
    batch = {"tokens": torch.from_numpy(data.global_batch_at(0)).to("cuda", torch.long),
             "frames": data.frames_at(0, "cuda")}
    errs, launched = _grads_vs_plain_attention(make_grad_fn(cfg32), params, batch)
    del params, batch
    worst = max(errs, key=lambda p: errs[p][0])
    log("train-encdec", f"the run's first step's gradients in f32 compute, the flash kernels (CUDA-core "
                        f"route: f32) against the plain attention on the card: {len(errs)} leaves, max |g - g_plain| "
                        f"/ max |g_plain| at most {errs[worst][0]:.3e} (tol {SEAMLESS_GRAD_TOL:g}; {worst}), "
                        f"||g - g_plain|| / ||g_plain|| at most {max(e[1] for e in errs.values()):.3e}; flash "
                        f"launches {launched[0]} forward / {launched[1]} backward")
    assert launched == (2 * layers, layers), launched
    assert errs[worst][0] <= SEAMLESS_GRAD_TOL, "the kernels' f32 gradients disagree with the plain attention's"
    gc.collect()
    torch.cuda.empty_cache()

    opt = AdamWConfig(learning_rate=1e-4, warmup_steps=2, total_steps=1000)
    kw = dict(seq_len=S, global_batch=B, data=data, device="cuda", stream_k=SEAMLESS_TRAIN["stream_k"])
    commits: list[dict] = []
    orig_rebuild = C.rebuild_state
    torch.cuda.reset_peak_memory_stats()
    C.rebuild_state = cut_checker(commits, lambda: ctrl, orig_rebuild)
    try:
        ctrl = LiveRController(cfg, ParallelConfig(dp=2, tp=2), opt, overlap="stream", wire_policy=WirePolicy(), **kw)
        _zero_counts()  # the training path's counts start here ...
        t_run = time.perf_counter()
        losses = ctrl.train_steps(SEAMLESS_TRAIN["before"])
        ctrl.request_resize(ParallelConfig(dp=2, tp=4))
        while not ctrl.records:
            losses += ctrl.train_steps(1)
            assert len(losses) < 200, "the streamed resize never committed"
        ctrl.wire_policy = None  # the second resize is lossless
        ctrl.request_resize(ParallelConfig(dp=1, tp=4), overlap="stop_copy")
        while len(ctrl.records) < 2:
            losses += ctrl.train_steps(1)
            assert len(losses) < 400, "the stop-copy resize never committed"
        snapshot = {p: x.clone() for p, x in tree_paths(ctrl.params).items()}
        at_commit = ctrl.step
        losses += ctrl.train_steps(SEAMLESS_TRAIN["after"])
        run_s = time.perf_counter() - t_run
        launches = _all_counts()  # ... and are read here
    finally:
        C.rebuild_state = orig_rebuild
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log("train-encdec", f"{cfg.name} full width ({cfg.encoder_layers} encoder + {cfg.num_layers} decoder layers, "
                        f"d_model {cfg.d_model}, vocab {cfg.vocab_size}, fp32 params, {cfg.dtype} compute, AdamW, "
                        f"remat per layer), batch {B} x {S} with frames ({B}, {S}, {cfg.d_model}), dp2tp2 -> "
                        f"dp2tp4 (stream, int8 moments) -> dp1tp4 (stop-copy, lossless): {len(losses)} steps in "
                        f"{run_s:.1f}s, losses {[round(x, 4) for x in losses]}, peak memory {peak_gb:.2f} GB, "
                        f"launches {launches}")
    assert all(np.isfinite(losses)), "a loss is not finite"
    assert [r.dst for r in ctrl.records] == ["dp2xpp1xtp4", "dp1xpp1xtp4"], [r.dst for r in ctrl.records]
    for i, (rec, c) in enumerate(zip(ctrl.records, commits)):
        pause_s = rec.total_pause_s - c["check_s"]  # the smoke's own check is not the system's pause
        log("train-encdec", f"commit {i + 1} {rec.mode} {rec.src} -> {rec.dst} at step {c['step']}: pause_s "
                            f"{pause_s:.4f}, prepare_s {rec.prepare_s:.4f}, wire {rec.wire_bytes / 1e9:.4f} GB, "
                            f"logical {rec.logical_bytes / 1e9:.4f} GB, executed {rec.executed_bytes / 1e9:.4f} GB, "
                            f"dirty layers {rec.dirty_layers}/{rec.layers_total}, {len(c['quantized'])} tensors "
                            f"quantized, {len(c['adopted'])} adopted")
        assert rec.generic_cells == 0
    first, second = commits
    assert ctrl.records[0].executed_bytes > 0 and ctrl.records[0].wire_bytes < ctrl.records[0].logical_bytes
    assert first["quantized"] and all(n.split("/")[0] in ("mu", "nu") for n in first["quantized"])
    assert any(n.startswith(("mu/encoder/", "nu/encoder/")) for n in first["quantized"])
    assert not second["quantized"] and ctrl.records[1].wire_bytes == ctrl.records[1].logical_bytes
    check_train_launches(launches, len(losses), SEAMLESS, phase="train-encdec")
    with_commit = {first["step"], second["step"] - 1}  # as in phase_train
    plain_steps = [t for i, t in enumerate(ctrl.iteration_times) if i not in with_commit]
    step_s = statistics.median(plain_steps)
    log("train-encdec", f"step time on the card (host clock, steps without a commit): median {step_s:.4f} s over "
                        f"{len(plain_steps)} steps, {B * S / step_s:.0f} tokens/s; flash launches a step "
                        f"{launches['flash_attention'] // len(losses)} forward / "
                        f"{launches['flash_attention_bwd'] // len(losses)} backward")
    log_step_profile("train-encdec", "one step on dp1tp4", profile_step(ctrl.world, ctrl.params, ctrl.opt_state,
                                                                        ctrl._batch(), _flash_class))
    del ctrl
    gc.collect()
    torch.cuda.empty_cache()

    control, c_losses = int8_control(cfg, opt, kw, first, at_commit)
    unequal = [p for p, x in tree_paths(control.params).items() if not torch.equal(x, snapshot[p])]
    log("train-encdec", f"params after the lossless commit (step {at_commit}) against the control run never "
                        f"resized: {len(snapshot) - len(unequal)} of {len(snapshot)} tensors bitwise equal; losses "
                        f"to there equal {c_losses == losses[:at_commit]}")
    assert not unequal, f"resized params differ from the control run's: {unequal[:4]}"
    assert c_losses == losses[:at_commit], "the resized run's losses differ from the control run's"
    del control, snapshot
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# the MoE slice: full width, the depth cut to fit one 80 GB card. mixtral
# serves 8 of its 32 layers (11.87 B params, 23.74 GB in bf16) and trains 1
# (1.71 B params: 20.56 GB of fp32 params and moments, 6.85 GB of
# gradients); jamba serves one period, 8 of its 32 layers
MIXTRAL = "mixtral-8x7b"
JAMBA = "jamba-v0.1-52b"
MOE_SERVE_LAYERS = 8
MIXTRAL_TRAIN_LAYERS = 1
# one request past mixtral's window of 4096: a prompt of two windows (the
# ring-aligned prefill the reference's cache takes) and 32 tokens decoded
# teacher-forced, their logits against the full forward's
WINDOW_CHECK = dict(prompt_len=8192, gen=32)
# the flash kernel's prefill and the ring cache's decode against the
# kernel's full forward through 8 layers: max |diff| over max |logit| of the
# full forward at those positions. In f32 compute at every position; in
# bf16 at the positions where every layer chose the same experts on both
# paths (where a choice differs, the position's logits move a long way)
WINDOW_TOL = 1e-3
WINDOW_BF16_TOL = 5e-2
MIXTRAL_ELASTIC_TRACE = [(8.0, ParallelConfig(dp=2, tp=2, ep=2)), (16.0, ParallelConfig(dp=1, tp=2, ep=4)),
                         (24.0, ParallelConfig(dp=1, tp=4))]
MIXTRAL_TRAIN = dict(batch=4, seq=1024, before=3, after=3, stream_k=1)
# the first step's f32 gradients through the kernels against the plain
# attention's: per leaf, max |g - g_plain| / max |g_plain|
MIXTRAL_GRAD_TOL = 1e-5


def moe_cut(arch: str, layers: int):
    return dataclasses.replace(get_config(arch), num_layers=layers)


class _routed:
    """Counts the (token, choice) pairs each ``moe.routing`` call routes
    (``routed``) and the pairs capacity drops (``dropped``), while it is
    entered, summed on the card and read at the exit (no sync in between).
    Keeps each call's expert choices (``choices``, (b, s, k)), its capacity
    and, per token, the cosine of its router input to its batch row's mean
    input (``likeness``, (b, s)), for :func:`log_routing`."""

    def __enter__(self):
        from repro_torch.models import moe as moe_mod

        self.mod, self.orig, self.kept = moe_mod, moe_mod.routing, []
        self.choices, self.capacity, self.likeness, self.routed = [], [], [], 0

        def counted(params, cfg, x):
            out = self.orig(params, cfg, x)
            self.kept.append(out[3].sum())
            self.routed += out[3].numel()
            self.choices.append(out[1])
            self.capacity.append(out[4])
            xf = x.detach().float()
            self.likeness.append(torch.nn.functional.cosine_similarity(xf, xf.mean(1, keepdim=True), dim=-1))
            return out

        moe_mod.routing = counted
        return self

    def __exit__(self, *exc):
        self.mod.routing = self.orig
        self.dropped = self.routed - sum(int(k) for k in self.kept)


def log_routing(phase: str, routed: _routed, calls: dict, e: int) -> None:
    """For each routing call ``calls`` names (``{label: index}``): each
    expert's share of the choices, the busiest (row, expert) pair's load
    against capacity, and by quarter of the positions the busiest expert's
    share and the router inputs' mean cosine to their row's mean."""
    for label, i in calls.items():
        idx, cap, like = routed.choices[i], routed.capacity[i], routed.likeness[i]
        b, s, k = idx.shape
        shares = torch.bincount(idx.flatten(), minlength=e).float() / idx.numel()
        per_row = torch.stack([torch.bincount(r.flatten(), minlength=e) for r in idx])
        quarters = [slice(q * s // 4, (q + 1) * s // 4) for q in range(4)]
        top = [(torch.bincount(idx[:, q].flatten(), minlength=e).max() / idx[:, q].numel()).item() for q in quarters]
        cos = [like[:, q].mean().item() for q in quarters]
        log(phase, f"routing, {label}: each expert's share of the {idx.numel()} choices "
                   f"{' '.join(f'{100 * x:.1f}' for x in shares.tolist())} %; the busiest expert of a row takes "
                   f"{int(per_row.max())} pairs against capacity {cap} ({b} rows x {s} tokens x top-{k}); by quarter "
                   f"of the positions the busiest expert's share {'/'.join(f'{100 * x:.1f}' for x in top)} % and the "
                   f"router inputs' mean cosine to their row's mean {'/'.join(f'{x:.3f}' for x in cos)}")


def phase_serve_moe(arch: str, layers: int = MOE_SERVE_LAYERS) -> tuple[dict, dict]:
    """``arch`` (mixtral-8x7b, jamba-v0.1-52b or llama4-scout-17b-a16e) at
    full width and ``layers`` layers through ``serve_once``, batch 8, prompt
    512, 32 greedy tokens; the params drawn part by part in bf16. Holds the
    first attention layer's q/k/v (and the first SSD layer's inputs) of the
    prefill against the plain versions, and the served world's tensors to
    the dry run's one-card argument bytes, leaf by leaf. Mixtral's weights then serve its chunked prefill (phase
    37). Returns the path's launches and the chunked path's (empty for
    jamba)."""
    import gc

    from repro_torch.models.transformer import block_program, n_periods

    cfg = moe_cut(arch, layers)
    prog = block_program(cfg)
    attn_layers = sum(m == "attn" for m, _ in prog) * n_periods(cfg)
    ssd_layers = cfg.num_layers - attn_layers
    moe_layers = sum(mlp == "moe" for _, mlp in prog) * n_periods(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    captured, orig_fa, orig_ssd = {}, ops.flash_attention, ssd_k.ssd_intra_chunk

    def capture_fa(q, k, v, **kw):
        if "flash" not in captured:
            captured["flash"] = (q.clone(), k.clone(), v.clone(), kw)
        return orig_fa(q, k, v, **kw)

    def capture_ssd(x, dt, cum, B, C, chunk):
        if "ssd" not in captured:
            captured["ssd"] = (x.clone(), dt.clone(), cum.clone(), B.clone(), C.clone(), chunk)
        return orig_ssd(x, dt, cum, B, C, chunk)

    ops.flash_attention, ssd_k.ssd_intra_chunk = capture_fa, capture_ssd
    try:
        _zero_counts()  # the main path's counts start here ...
        out = serve_once(cfg, device="cuda", seed=0, **SERVE)
        launches = {"flash_attention": fa.launches, "flash_attention_tc": fa.tc_launches,
                    "ssd_intra_chunk": ssd_k.launches}  # ... and are read here
    finally:
        ops.flash_attention, ssd_k.ssd_intra_chunk = orig_fa, orig_ssd
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    toks = out["tokens"]
    tok_s = SERVE["batch"] * SERVE["gen"] / out["decode_s"]
    n_params = M.analytic_param_count(cfg)
    log("serve-moe", f"{cfg.name} full width, {cfg.num_layers} of {get_config(arch).num_layers} layers ({attn_layers} "
                     f"attention, {ssd_layers} SSD; {moe_layers} MoE MLPs of {cfg.num_experts} experts top-"
                     f"{cfg.experts_per_token} at d_ff {cfg.d_ff}; d_model {cfg.d_model}, vocab {cfg.vocab_size}; "
                     f"{n_params} params, {2 * n_params / 1e9:.2f} GB in bf16), batch {SERVE['batch']} x prompt "
                     f"{SERVE['prompt_len']}, {SERVE['gen']} greedy tokens: prefill_s {out['prefill_s']:.4f}, decode_s "
                     f"{out['decode_s']:.4f} ({tok_s:.1f} tok/s), peak memory {peak_gb:.2f} GB, launches {launches}")
    assert launches["flash_attention"] == attn_layers and launches["ssd_intra_chunk"] == ssd_layers, launches
    assert fa.route(getattr(torch, cfg.dtype), cfg.resolved_head_dim) == "tensor_cores"
    assert launches["flash_attention_tc"] == launches["flash_attention"], launches
    assert toks.shape == (SERVE["batch"], SERVE["gen"] + 1), toks.shape
    assert toks.min() >= 0 and toks.max() < cfg.vocab_size
    q, k, v, kw = captured.pop("flash")
    err = kernel_vs_plain(q, k, v, **kw)
    case = (*q.shape[:2], k.shape[1], q.shape[2], k.shape[2], q.shape[3], kw["causal"], kw["window"])
    rel = bwd_vs_plain(case, q.dtype, seed=0, qkv=(q, k, v), scale=kw["scale"])
    log("serve-moe", f"first attention layer's prefill {tuple(q.shape)} {str(q.dtype)[6:]} window {kw['window']}: "
                     f"kernel vs plain max_abs_err {err:.3e} (tol {TOL[q.dtype]:g}); backward max |error| / max "
                     f"|plain| {rel:.3e} (tol {BWD_TOL[q.dtype]:g})")
    assert err <= TOL[q.dtype] and rel <= BWD_TOL[q.dtype]
    if ssd_layers:
        args = captured.pop("ssd")
        ssd_err = ssd_kernel_vs_plain(*args)
        log("serve-moe", f"first SSD layer's block x {tuple(args[0].shape)} {str(args[0].dtype)[6:]}: kernel vs "
                         f"plain max |error| / max |plain| {ssd_err:.3e} (tol {SSD_TOL:g})")
        assert ssd_err <= SSD_TOL
    del captured, q, k, v

    # the logits themselves: finite, of the expected shape, the first tokens;
    # then where the prefill's and a decode step's device time goes
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda", served_dtype=cfg.dtype)
    check_world_bytes("serve-moe", f"{cfg.name} served world ({cfg.num_layers} layers, bf16)",
                      leaf_bytes(params=params, batch=demo_batch(cfg, SERVE["batch"], SERVE["prompt_len"])), cfg,
                      CARD_PREFILL, {"served_dtype": cfg.dtype, "max_seq": SERVE["prompt_len"] + SERVE["gen"]})
    with torch.inference_mode(), _routed() as routed:
        logits, cache, _ = M.prefill(cfg, params, demo_batch(cfg, SERVE["batch"], SERVE["prompt_len"]),
                                     max_seq=SERVE["prompt_len"] + 4)
    assert logits.shape == (SERVE["batch"], 1, cfg.vocab_size)
    assert torch.isfinite(logits.float()).all(), "full-width logits not finite"
    assert (logits[:, -1].argmax(-1).cpu().numpy() == toks[:, 0]).all()
    log("serve-moe", f"full-width prefill logits {tuple(logits.shape)} finite; first tokens match; capacity factor "
                     f"{cfg.moe_capacity_factor:g} dropped {routed.dropped} of {routed.routed} (token, choice) pairs "
                     f"in the prefill ({100 * routed.dropped / routed.routed:.2f}%)")
    last = len(routed.choices) - 1
    log_routing("serve-moe", routed, {"the prefill's MoE layer 1": 0, f"its MoE layer {last + 1}": last},
                cfg.num_experts)
    del routed
    phase_profile(cfg, params, logits, cache)
    del logits, cache
    chunked = phase_chunked_prefill(arch, params) if arch == MIXTRAL else {}
    del params
    if arch == MIXTRAL:
        phase_window(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    return launches, chunked


def _window_logits(cfg, params, toks, s: int, n: int):
    """The full forward's logits at positions ``s..s+n-1`` and the same
    positions decoded teacher-forced through the ring cache after a prefill
    of ``s`` tokens; the flash launches' (length, window), the prefill's
    first flash launch's inputs, the routing calls (:class:`_routed`), the
    prefill's seconds and the ring's slots."""
    calls, first, orig = [], {}, ops.flash_attention

    def seen(q, k, v, **kw):
        calls.append((q.shape[1], kw["window"]))
        if q.shape[1] == s and not first:
            first.update(qkv=(q.clone(), k.clone(), v.clone()), kw=kw)
        return orig(q, k, v, **kw)

    cache_dtype = getattr(torch, cfg.dtype)
    ops.flash_attention = seen
    try:
        with torch.inference_mode(), _routed() as routed:
            full, _ = M.forward(cfg, params, {"tokens": toks})
            want = full[0, s:].float()
            del full
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, cache, _ = M.prefill(cfg, params, {"tokens": toks[:, :s]}, cache_dtype=cache_dtype, max_seq=s + n)
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
            ring = cache["pos0"]["k"].shape[2]
            got = []
            for i in range(n):
                logits, cache = M.decode_step(cfg, params, cache, toks[:, s + i : s + i + 1], s + i)
                got.append(logits[0, 0].float())
    finally:
        ops.flash_attention = orig
    return want, torch.stack(got), calls, first, routed, prefill_s, ring


def routing_flips(routed: _routed, s: int, n: int) -> tuple[list, list, torch.Tensor]:
    """The routing calls of :func:`_window_logits` (the full forward's
    layers, the prefill's, then each decode step's) compared layer by layer:
    per layer, the prompt tokens whose set of experts differs between the
    prefill and the full forward, and the decode positions whose set differs
    from the full forward's; and per decode position, whether any layer's
    set differs there."""
    layers = len(routed.choices) // (n + 2)
    assert len(routed.choices) == layers * (n + 2), len(routed.choices)
    full, pre, dec = routed.choices[:layers], routed.choices[layers:2 * layers], routed.choices[2 * layers:]

    def differ(a, b):
        return (a.sort(-1).values != b.sort(-1).values).any(-1)

    prompt = [int(differ(full[j][:, :s], pre[j]).sum()) for j in range(layers)]
    by_layer = [torch.stack([differ(full[j][0, s + i], dec[i * layers + j][0, 0]) for i in range(n)])
                for j in range(layers)]
    return prompt, [int(f.sum()) for f in by_layer], torch.stack(by_layer).any(0)


def phase_window(cfg) -> None:
    """One mixtral request past its window at full width: the prefill of
    ``WINDOW_CHECK["prompt_len"]`` tokens (the flash kernel masking by the
    window of 4096), then 32 tokens through the ring cache, which wraps,
    teacher-forced; their logits against the full forward's at the same
    positions. The capacity factor is num_experts / k here, a capacity of
    every token: capacity is counted per call, so below it a prefill and
    decode steps do not compute what one full forward does. In bf16 (the
    served params) the prefill's first flash launch is held against the
    plain version forward and backward, each layer's expert choices of the
    two paths are compared, and the logits are held to ``WINDOW_BF16_TOL``
    at the decode positions where no layer chose other experts (a flipped
    choice moves a position's logits a long way: logged). In f32 compute
    (f32 params, the flash kernel's CUDA-core route, TF32 off) every
    position's logits are held to ``WINDOW_TOL``."""
    import gc

    cfg = dataclasses.replace(cfg, moe_capacity_factor=cfg.num_experts / cfg.experts_per_token)
    s, n = WINDOW_CHECK["prompt_len"], WINDOW_CHECK["gen"]
    assert s % cfg.sliding_window == 0 and s > cfg.sliding_window
    gen = torch.Generator(device="cuda").manual_seed(11)
    toks = torch.randint(0, cfg.vocab_size, (1, s + n), generator=gen, device="cuda")
    for dtype in ("bfloat16", "float32"):
        run_cfg = dataclasses.replace(cfg, dtype=dtype)
        gc.collect()
        torch.cuda.empty_cache()
        params = M.init_params(run_cfg, torch.Generator(device="cuda").manual_seed(0), "cuda", served_dtype=dtype)
        want, got, calls, first, routed, prefill_s, ring = _window_logits(run_cfg, params, toks, s, n)
        del params
        prompt_flips, decode_flips, flipped = routing_flips(routed, s, n)
        del routed
        scale = want.abs().max()
        err = ((got - want).abs().max() / scale).item()
        clean = ~flipped
        clean_err = ((got[clean] - want[clean]).abs().max() / scale).item() if clean.any() else float("nan")
        flipped_err = ((got[flipped] - want[flipped]).abs().max() / scale).item() if flipped.any() else 0.0
        agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
        log("window", f"{cfg.name} {cfg.num_layers} layers, {dtype} compute, one request: prompt {s} (the flash "
                      f"kernel at window {cfg.sliding_window}: {len(calls)} launches, "
                      f"{sum(w == cfg.sliding_window and q > w for q, w in calls)} of them longer than the window), "
                      f"prefill_s {prefill_s:.4f}, ring cache of {ring} slots, {n} decode steps teacher-forced at "
                      f"positions {s}..{s + n - 1} (the ring wrapped {n} slots) against the full forward over "
                      f"{s + n} tokens: max |diff| / max |logit| {err:.3e} over all {n} positions, greedy tokens "
                      f"equal at {100 * agree:.1f}% of them")
        log("window", f"  {dtype}: layer by layer, the prompt tokens whose experts differ between the prefill and "
                      f"the full forward {prompt_flips}, the decode positions whose experts differ from the full "
                      f"forward's {decode_flips}; {int(flipped.sum())} of {n} decode positions with a choice that "
                      f"differs in some layer (max |diff| / max |logit| {flipped_err:.3e} there), {int(clean.sum())} "
                      f"with none ({clean_err:.3e} there, tol {WINDOW_BF16_TOL:g} in bf16)")
        assert ring == cfg.sliding_window and torch.isfinite(got).all()
        assert all(w == cfg.sliding_window for _, w in calls) and max(q for q, _ in calls) > cfg.sliding_window
        if dtype == "float32":
            assert err <= WINDOW_TOL, "the ring cache's decode disagrees with the full forward"
            continue
        assert clean.sum() >= n // 2, "most decode positions chose other experts than the full forward"
        assert clean_err <= WINDOW_BF16_TOL, "the ring cache's decode disagrees with the full forward"
        del want, got
        gc.collect()
        torch.cuda.empty_cache()
        (q, k, v), kw = first["qkv"], first["kw"]
        assert kw["window"] == cfg.sliding_window and q.shape[1] == s
        assert fa.route(q.dtype, q.shape[-1]) == "tensor_cores"
        ferr = kernel_vs_plain(q, k, v, **kw)
        case = (*q.shape[:2], k.shape[1], q.shape[2], k.shape[2], q.shape[3], kw["causal"], kw["window"])
        rel = bwd_vs_plain(case, q.dtype, seed=0, qkv=(q, k, v), scale=kw["scale"])
        log("window", f"  the prefill's first flash launch {tuple(q.shape)} {dtype} window {kw['window']} (tensor "
                      f"cores): kernel vs plain max_abs_err {ferr:.3e} (tol {TOL[q.dtype]:g}); backward max |error| / "
                      f"max |plain| {rel:.3e} (tol {BWD_TOL[q.dtype]:g})")
        assert ferr <= TOL[q.dtype] and rel <= BWD_TOL[q.dtype]
        del q, k, v, first
    gc.collect()
    torch.cuda.empty_cache()


def phase_elastic_mixtral() -> dict:
    """mixtral at full width and 8 layers through ``elastic_run``, resized
    mid-generation across expert-parallel degrees: dp2tp2 -> dp2tp2ep2 ->
    dp1tp2ep4 -> dp1tp4. Every commit changes ep, so every one moves the
    expert matrices' slices."""
    cfg = moe_cut(MIXTRAL, MOE_SERVE_LAYERS)
    run = elastic_run(cfg, MIXTRAL_ELASTIC_TRACE)
    records, commits, launches = run["records"], run["commits"], run["launches"]
    experts = {f"params/blocks/pos0/mlp/{n}" for n in ("wi_gate", "wi_up", "wo")}
    for rec, c in zip(records, commits):
        assert rec.executed_bytes > 0 and experts <= c["moved"], (rec.dst, sorted(c["moved"])[:8])
        assert c["launched"]["pack_rows"] == c["launched"]["scatter_rows"] > 0, c["launched"]
    assert launches["flash_attention"] == cfg.num_layers and launches["ssd_intra_chunk"] == 0, launches
    log("elastic", f"{cfg.name}: every commit moved the expert matrices ({', '.join(sorted(experts))}); peak memory "
                   f"of the commits {max(c['peak_gb'] for c in commits):.2f} GB")
    return launches


def phase_train_mixtral() -> dict:
    """mixtral at full width and 1 layer trained and live-resized across
    expert-parallel degrees (see the module docstring, 35). Returns the
    launches of the path."""
    import gc

    from repro_torch.core import controller as C
    from repro_torch.core.controller import LiveRController
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.distribution.step import make_grad_fn
    from repro_torch.optim import AdamWConfig
    from repro_torch.reshard import WirePolicy
    from repro_torch.utils.pytree import tree_paths

    cfg = moe_cut(MIXTRAL, MIXTRAL_TRAIN_LAYERS)
    B, S = MIXTRAL_TRAIN["batch"], MIXTRAL_TRAIN["seq"]
    gc.collect()
    torch.cuda.empty_cache()
    # the run's first step (its init and tokens) in f32 compute: the kernels
    # against the plain attention; and the pairs capacity drops in it
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = M.init_params(cfg32, torch.Generator(device="cuda").manual_seed(0), "cuda")
    batch = {"tokens": torch.from_numpy(SyntheticLM(cfg.vocab_size, S, B, 0).global_batch_at(0)).to("cuda", torch.long)}
    with _routed() as routed:
        errs, launched = _grads_vs_plain_attention(make_grad_fn(cfg32), params, batch)
    del params, batch
    worst = max(errs, key=lambda p: errs[p][0])
    log("train-moe", f"the run's first step's gradients in f32 compute, the flash kernels (CUDA-core route: f32) "
                     f"against the plain attention on the card: {len(errs)} leaves, max |g - g_plain| / max |g_plain| "
                     f"at most {errs[worst][0]:.3e} (tol {MIXTRAL_GRAD_TOL:g}; {worst}), ||g - g_plain|| / "
                     f"||g_plain|| at most {max(e[1] for e in errs.values()):.3e}; flash launches {launched[0]} "
                     f"forward / {launched[1]} backward")
    log("train-moe", f"capacity factor {cfg.moe_capacity_factor:g} (capacity "
                     f"{max(1, int(cfg.moe_capacity_factor * cfg.experts_per_token * S / cfg.num_experts))} pairs an "
                     f"expert a row of {S} tokens) dropped {routed.dropped} of {routed.routed} (token, choice) pairs, "
                     f"{100 * routed.dropped / routed.routed:.2f}%, over the two steps' routings (forward, remat and "
                     f"plain)")
    log_routing("train-moe", routed, {"the first step's forward": 0}, cfg.num_experts)
    del routed
    assert launched == (2 * cfg.num_layers, cfg.num_layers), launched
    assert errs[worst][0] <= MIXTRAL_GRAD_TOL, "the kernels' f32 gradients disagree with the plain attention's"
    gc.collect()
    torch.cuda.empty_cache()

    opt = AdamWConfig(learning_rate=1e-4, warmup_steps=2, total_steps=1000)
    kw = dict(seq_len=S, global_batch=B, device="cuda", stream_k=MIXTRAL_TRAIN["stream_k"])
    first_dst, second_dst = ParallelConfig(dp=2, tp=2, ep=2), ParallelConfig(dp=1, tp=2, ep=4)
    commits: list[dict] = []
    orig_rebuild = C.rebuild_state
    torch.cuda.reset_peak_memory_stats()
    C.rebuild_state = cut_checker(commits, lambda: ctrl, orig_rebuild)
    try:
        ctrl = LiveRController(cfg, ParallelConfig(dp=2, tp=2), opt, overlap="stream", wire_policy=WirePolicy(), **kw)
        _zero_counts()  # the training path's counts start here ...
        t_run = time.perf_counter()
        losses = ctrl.train_steps(MIXTRAL_TRAIN["before"])
        ctrl.request_resize(first_dst)
        while not ctrl.records:
            losses += ctrl.train_steps(1)
            assert len(losses) < 200, "the streamed resize never committed"
        ctrl.wire_policy = None  # the second resize is lossless
        ctrl.request_resize(second_dst, overlap="stop_copy")
        while len(ctrl.records) < 2:
            losses += ctrl.train_steps(1)
            assert len(losses) < 400, "the stop-copy resize never committed"
        snapshot = {p: x.clone() for p, x in tree_paths(ctrl.params).items()}
        at_commit = ctrl.step
        losses += ctrl.train_steps(MIXTRAL_TRAIN["after"])
        run_s = time.perf_counter() - t_run
        launches = _all_counts()  # ... and are read here
    finally:
        C.rebuild_state = orig_rebuild
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log("train-moe", f"{cfg.name} full width, {cfg.num_layers} of 32 layers ({M.analytic_param_count(cfg)} params, "
                     f"fp32, {cfg.dtype} compute, AdamW, remat per layer, the MoE aux loss in the loss), batch {B} x "
                     f"{S}, dp2tp2 -> {_short(first_dst)} (stream, int8 moments) -> {_short(second_dst)} (stop-copy, "
                     f"lossless): {len(losses)} steps in {run_s:.1f}s, losses {[round(x, 4) for x in losses]}, peak "
                     f"memory {peak_gb:.2f} GB, launches {launches}")
    assert all(np.isfinite(losses)), "a loss is not finite"
    assert [r.dst for r in ctrl.records] == [first_dst.describe(), second_dst.describe()], [r.dst for r in ctrl.records]
    for i, (rec, c) in enumerate(zip(ctrl.records, commits)):
        pause_s = rec.total_pause_s - c["check_s"]  # the smoke's own check is not the system's pause
        log("train-moe", f"commit {i + 1} {rec.mode} {rec.src} -> {rec.dst} at step {c['step']}: pause_s "
                         f"{pause_s:.4f}, prepare_s {rec.prepare_s:.4f}, wire {rec.wire_bytes / 1e9:.4f} GB, "
                         f"logical {rec.logical_bytes / 1e9:.4f} GB, executed {rec.executed_bytes / 1e9:.4f} GB, "
                         f"dirty layers {rec.dirty_layers}/{rec.layers_total}, {len(c['quantized'])} tensors "
                         f"quantized, {len(c['adopted'])} adopted")
        assert rec.generic_cells == 0 and rec.executed_bytes > 0
    first, second = commits
    assert ctrl.records[0].wire_bytes < ctrl.records[0].logical_bytes
    assert any("/mlp/wi_gate" in n for n in first["quantized"]), first["quantized"]
    assert all(n.split("/")[0] in ("mu", "nu") for n in first["quantized"])
    assert not second["quantized"] and ctrl.records[1].wire_bytes == ctrl.records[1].logical_bytes
    check_train_launches(launches, len(losses), cfg, phase="train-moe")
    with_commit = {first["step"], second["step"] - 1}  # as in phase_train
    plain_steps = [t for i, t in enumerate(ctrl.iteration_times) if i not in with_commit]
    step_s = statistics.median(plain_steps)
    log("train-moe", f"step time on the card (host clock, steps without a commit): median {step_s:.4f} s over "
                     f"{len(plain_steps)} steps, {B * S / step_s:.0f} tokens/s")
    log_step_profile("train-moe", f"one step on {_short(second_dst)}",
                     profile_step(ctrl.world, ctrl.params, ctrl.opt_state, ctrl._batch(), _flash_class))
    del ctrl
    gc.collect()
    torch.cuda.empty_cache()

    control, c_losses = int8_control(cfg, opt, kw, first, at_commit)
    unequal = [p for p, x in tree_paths(control.params).items() if not torch.equal(x, snapshot[p])]
    log("train-moe", f"params after the lossless commit (step {at_commit}) against the control run never resized: "
                     f"{len(snapshot) - len(unequal)} of {len(snapshot)} tensors bitwise equal; losses to there equal "
                     f"{c_losses == losses[:at_commit]}")
    assert not unequal, f"resized params differ from the control run's: {unequal[:4]}"
    assert c_losses == losses[:at_commit], "the resized run's losses differ from the control run's"
    del control, snapshot
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# chunked prefill (phase 37): qwen3 and mamba2 at full width, batch 8 x
# 512 in chunks of 128, then 32 greedy tokens; mixtral at 8 layers, one
# request of 8192 tokens in chunks of 2048 through its ring of 4096
CHUNKED = dict(batch=8, prompt_len=512, chunk=128, gen=32)
CHUNKED_MOE = dict(prompt_len=8192, chunk=2048)
# bf16 logits of the chunked path against whole prefill's (or, for
# mixtral, the chunked path's with the plain attention): max |diff| / max
# |logit|, the window check's bound
CHUNKED_TOL = 5e-2
# timed runs of each prefill after its warm-up: their median is printed
CHUNKED_REPS = 3


def _chunked_run(cfg, params, toks, chunk: int):
    """``prefill_chunked`` of ``toks`` on the card, timed to a sync:
    (last logits, cache, seconds, the host's seconds until the call
    returned, peak GB, launches, the flash launches' (queries, keys,
    window), the first launch's inputs by chunk)."""
    calls, firsts, orig_fa, orig_ssd = [], {}, ops.flash_attention, ssd_k.ssd_intra_chunk

    def seen_fa(q, k, v, **kw):
        calls.append((q.shape[1], k.shape[1], kw["window"]))
        if ("flash", k.shape[1]) not in firsts:  # copied on first sight only
            firsts[("flash", k.shape[1])] = (q.clone(), k.clone(), v.clone(), kw)
        return orig_fa(q, k, v, **kw)

    def seen_ssd(x, dt, cum, B, C, c):
        if ("ssd", "first") not in firsts:
            firsts[("ssd", "first")] = (x.clone(), dt.clone(), cum.clone(), B.clone(), C.clone(), c)
        return orig_ssd(x, dt, cum, B, C, c)

    ops.flash_attention, ssd_k.ssd_intra_chunk = seen_fa, seen_ssd
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        _zero_counts()  # the chunked path's counts start here ...
        t0 = time.perf_counter()
        with torch.inference_mode():
            logits, cache = M.prefill_chunked(cfg, params, {"tokens": toks}, chunk, max_seq=toks.shape[1] + CHUNKED["gen"],
                                              cache_dtype=getattr(torch, cfg.dtype))
        issued = time.perf_counter() - t0
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {"flash_attention": fa.launches, "flash_attention_tc": fa.tc_launches,
                    "ssd_intra_chunk": ssd_k.launches}  # ... and are read here
    finally:
        ops.flash_attention, ssd_k.ssd_intra_chunk = orig_fa, orig_ssd
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    return logits, cache, seconds, issued, peak, launches, calls, firsts


def _whole_run(cfg, params, toks):
    """Whole prefill of ``toks``, timed to a sync: (last logits, cache,
    seconds, the host's seconds until the call returned, peak GB above
    the params)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    with torch.inference_mode():
        logits, cache, _ = M.prefill(cfg, params, {"tokens": toks}, cache_dtype=getattr(torch, cfg.dtype),
                                     max_seq=toks.shape[1] + CHUNKED["gen"])
    issued = time.perf_counter() - t0
    torch.cuda.synchronize()
    return logits, cache, time.perf_counter() - t0, issued, (torch.cuda.max_memory_allocated() - base) / 1e9


def _secs(runs: list) -> str:
    """The median [min, max] of the timed runs' seconds, and the median of
    the host's seconds until each call returned."""
    s = [t for t, _ in runs]
    return (f"{statistics.median(s):.4f} [{min(s):.4f}, {max(s):.4f}] (the host's call returned at "
            f"{statistics.median([i for _, i in runs]):.4f})")


def _teacher_forced(cfg, params, cache, first: torch.Tensor, forced: torch.Tensor, s: int):
    """Decode ``forced`` (b, n) from ``cache`` after a prompt of ``s``
    tokens, ``first`` (b, 1) the first input: the logits of each step."""
    out, cur = [], first
    with torch.inference_mode():
        for i in range(forced.shape[1]):
            logits, cache = M.decode_step(cfg, params, cache, cur, s + i)
            out.append(logits[:, 0].float())
            cur = forced[:, i : i + 1]
    return torch.stack(out, dim=1)


def phase_chunked_prefill(arch: str, params=None) -> dict:
    """Chunked prefill on the card (see the module docstring, 37): qwen3 or
    mamba2 at full width against whole prefill, or mixtral at 8 layers
    (``params``: phase 33's) against the same chunked function with the
    plain attention. Returns the chunked path's launches."""
    import gc

    from repro_torch.models.kvcache import cache_capacity

    moe = arch == MIXTRAL
    cfg = moe_cut(arch, MOE_SERVE_LAYERS) if moe else get_config(arch)
    gc.collect()
    torch.cuda.empty_cache()
    if params is None:
        params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda", served_dtype=cfg.dtype)
    b, s, chunk = (1, CHUNKED_MOE["prompt_len"], CHUNKED_MOE["chunk"]) if moe else \
        (CHUNKED["batch"], CHUNKED["prompt_len"], CHUNKED["chunk"])
    gen = torch.Generator(device="cuda").manual_seed(13)
    toks = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device="cuda")
    # a warm-up of each path (its shapes' first cuBLAS and allocator calls),
    # then the timed runs
    for warm in (_chunked_run(cfg, params, toks, chunk), _whole_run(cfg, params, toks)):
        del warm
    chunked_t, whole_t = [], []
    for _ in range(CHUNKED_REPS):
        logits = cache = None  # the previous run's, freed first
        logits, cache, sec, issued, chunked_gb, launches, calls, firsts = _chunked_run(cfg, params, toks, chunk)
        chunked_t.append((sec, issued))
    for _ in range(CHUNKED_REPS):
        whole = wcache = None
        whole, wcache, sec, issued, whole_gb = _whole_run(cfg, params, toks)
        whole_t.append((sec, issued))
    chunked_s = statistics.median([t for t, _ in chunked_t])
    attn_layers = len(calls) // (s // chunk)
    ssd_layers = launches["ssd_intra_chunk"] // (s // chunk)
    assert torch.isfinite(logits.float()).all() and logits.shape == (b, 1, cfg.vocab_size)
    assert launches["flash_attention"] == attn_layers * (s // chunk) and launches["flash_attention_tc"] == \
        launches["flash_attention"], launches
    assert attn_layers + ssd_layers == cfg.num_layers, (attn_layers, ssd_layers)
    keys = sorted({(t, w) for _, t, w in calls})
    tag = "chunked-" + ("mixtral" if moe else cfg.name.split("-")[0])
    # every flash launch of the path's first chunk and, through the ring,
    # of its first wrapped chunk, held against the plain version
    for key in sorted(k for k in firsts if k[0] == "flash"):
        q, k, v, kw = firsts[key]
        if key[1] not in (chunk, max(t for t, _ in keys)):
            continue
        assert fa.route(q.dtype, q.shape[-1]) == "tensor_cores"
        err = kernel_vs_plain(q, k, v, **kw)
        log(tag, f"flash launch q {tuple(q.shape)} against {k.shape[1]} keys, window {kw['window']}, "
                 f"{str(q.dtype)[6:]} on the tensor cores: kernel vs plain max_abs_err {err:.3e} "
                 f"(tol {TOL[q.dtype]:g})")
        assert err <= TOL[q.dtype]
    if ("ssd", "first") in firsts:
        args = firsts[("ssd", "first")]
        ssd_err = ssd_kernel_vs_plain(*args)
        log(tag, f"first SSD layer's block x {tuple(args[0].shape)} {str(args[0].dtype)[6:]}: kernel vs plain "
                 f"max |error| / max |plain| {ssd_err:.3e} (tol {SSD_TOL:g})")
        assert ssd_err <= SSD_TOL
    del firsts
    if moe:
        from repro_torch.models import attention as attn_mod
        from repro_torch.models import layers as L
        from repro_torch.models import transformer as T

        # the first layer's attention output of every chunk, untimed: no
        # routing comes before it, so through the ring it must equal the
        # whole prompt's first-layer attention at the same positions
        layer0, orig_chunk = {}, attn_mod.attn_chunk

        def chunk0(p, c, x, ck, cv, pos0):
            out = orig_chunk(p, c, x, ck, cv, pos0)
            if pos0 not in layer0:  # a chunk's first call is the first layer's
                layer0[pos0] = out[0].clone()
            return out

        # the same chunked function with the plain attention (capacity is
        # counted per call, so whole prefill routes other pairs at 1.25)
        attn_mod.attn_chunk = chunk0
        try:
            with _routed() as routed_k:
                logits, cache, *_ = _chunked_run(cfg, params, toks, chunk)
        finally:
            attn_mod.attn_chunk = orig_chunk
        del cache
        bp = T._period(params["blocks"], 0)["pos0"]
        with torch.inference_mode():
            h0 = L.rmsnorm_apply(bp["ln1"], L.embed_apply(params["embed"], toks, getattr(torch, cfg.dtype)))
            want0 = attn_mod.attn_forward(bp["mixer"], cfg, h0, torch.arange(s, dtype=torch.int32, device="cuda")
                                          .expand(b, s)).float()
        got0 = torch.cat([layer0[p0] for p0 in sorted(layer0)], dim=1).float()
        err0 = ((got0 - want0).abs().max() / want0.abs().max()).item()
        wrapped = [p0 for p0 in sorted(layer0) if p0 + chunk > cfg.sliding_window]
        err0_wrapped = ((got0[:, wrapped[0]:] - want0[:, wrapped[0]:]).abs().max() / want0.abs().max()).item()
        del h0, want0, got0, layer0
        orig = ops.flash_attention
        ops.flash_attention = flash_attention_ref
        try:
            with _routed() as routed_p:
                plain, pcache, plain_s, _, plain_gb, *_ = _chunked_run(cfg, params, toks, chunk)
        finally:
            ops.flash_attention = orig
        del pcache
        flips = [int((a[:, -1].sort(-1).values != p[:, -1].sort(-1).values).any()) for a, p in
                 zip(routed_k.choices, routed_p.choices)]
        err = ((logits.float() - plain.float()).abs().max() / plain.float().abs().max()).item()
        whole_err = ((logits.float() - whole.float()).abs().max() / whole.float().abs().max()).item()
        flipped = [i for i, f in enumerate(flips) if f]
        del wcache
        log(tag, f"{cfg.name} {cfg.num_layers} layers, one request of {s} tokens in chunks of {chunk} (ring of "
                 f"{cache_capacity(cfg, s + CHUNKED['gen'])} slots, window {cfg.sliding_window}; flash (keys, "
                 f"window) {keys}): "
                 f"prefill_s over {CHUNKED_REPS} runs chunked {_secs(chunked_t)} / whole {_secs(whole_t)} (plain "
                 f"attention chunked {plain_s:.4f}), "
                 f"peak above the params chunked {chunked_gb:.2f} / whole {whole_gb:.2f} GB (plain {plain_gb:.2f}); "
                 f"last logits against the plain attention's: max |diff| / max |logit| {err:.3e} (tol "
                 f"{CHUNKED_TOL:g}); the last token's experts differ in layers {flipped}; against whole prefill "
                 f"{whole_err:.3e} (capacity per call); launches {launches}")
        log(tag, f"the first layer's attention output of each chunk against the whole prompt's first-layer "
                 f"attention (no routing before it): max |diff| / max |out| {err0:.3e} over all {s} positions, "
                 f"{err0_wrapped:.3e} over the chunks at positions {wrapped} that wrap the ring (tol "
                 f"{CHUNKED_TOL:g})")
        assert max(t for t, _ in keys) == cfg.sliding_window + chunk and all(w == cfg.sliding_window for _, w in keys)
        assert err0 <= CHUNKED_TOL, "the ring's first-layer attention disagrees with the whole prompt's"
        assert not flipped, "the last token chose other experts than with the plain attention"
        assert err <= CHUNKED_TOL, "the chunked path disagrees with its plain attention"
        del logits, plain, whole
        gc.collect()
        torch.cuda.empty_cache()
        return launches
    err = ((logits.float() - whole.float()).abs().max() / whole.float().abs().max()).item()
    # greedy tokens after whole prefill, then the chunked cache fed the same
    # tokens: where its argmax differs, a bf16 flip
    n = CHUNKED["gen"]
    first = whole[:, -1].argmax(-1, keepdim=True)
    greedy = [first]
    with torch.inference_mode():
        cur = first
        for i in range(n):
            lg, wcache = M.decode_step(cfg, params, wcache, cur, s + i)
            cur = lg[:, -1].argmax(-1, keepdim=True)
            greedy.append(cur)
    greedy = torch.cat(greedy, dim=1)
    del wcache
    got = _teacher_forced(cfg, params, cache, logits[:, -1].argmax(-1, keepdim=True), greedy[:, 1:], s)
    picked = torch.cat([logits[:, -1].argmax(-1, keepdim=True), got.argmax(-1)[:, :-1]], dim=1)
    flips = [(r, int(c)) for r, c in (picked != greedy[:, :n]).nonzero().tolist()]
    del cache
    log(tag, f"{cfg.name} full width ({cfg.num_layers} layers), batch {b} x prompt {s} in chunks of {chunk}: "
             f"prefill_s over {CHUNKED_REPS} runs chunked {_secs(chunked_t)} / whole {_secs(whole_t)}, peak above "
             f"the params chunked "
             f"{chunked_gb:.2f} / whole {whole_gb:.2f} GB, launches {launches} (flash keys "
             f"{sorted(t for t, _ in keys)}); "
             f"last logits against whole prefill's: max |diff| / max |logit| {err:.3e} (tol {CHUNKED_TOL:g}); "
             f"{n} greedy tokens teacher-forced through the chunked cache: {len(flips)} of {b * n} argmax flips "
             f"(row, step) {flips[:12]}")
    assert err <= CHUNKED_TOL, "chunked prefill disagrees with whole prefill"
    assert torch.isfinite(got).all()
    assert len(flips) <= b * n // 4, "most greedy tokens differ after chunked prefill"
    if ssd_layers == 0:
        # the price of the cache slice's copy for the kernel (b > 1: a
        # slice of the slots is not contiguous), at each chunk's key length
        k0 = torch.zeros((b, s + n, cfg.num_kv_heads, cfg.resolved_head_dim), dtype=getattr(torch, cfg.dtype),
                         device="cuda")
        copy_ms = [median_ms(lambda t=t: k0[:, :t].contiguous()) for t in range(chunk, s + 1, chunk)]
        log(tag, f"the K (and V) slice copies a layer a chunk: {[round(x, 4) for x in copy_ms]} ms at "
                 f"{list(range(chunk, s + 1, chunk))} keys; {2 * cfg.num_layers * sum(copy_ms):.3f} ms a prefill "
                 f"of the chunked path's {1e3 * chunked_s:.3f}")
        del k0
    del logits, whole, got, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# pipeline training (phase 38): qwen3-1.7b as in TRAIN cut to 8 of its 28
# layers (fp32 params, bf16 compute, batch 4 x 1024; 28 layers before phase
# 43 came, for the script's time); the first-step check at 4 layers in f32
# compute
PIPELINE = dict(layers=8, before=3, between=2, after=2, stream_k=8, check_layers=4)
PP2TP2, DP2TP2, PP4TP1 = ParallelConfig(pp=2, tp=2), ParallelConfig(dp=2, tp=2), ParallelConfig(pp=4)
# the pipelined first step's f32 gradients against the dense step's with
# the same microbatches: per leaf, max |g - g_dense| / max |g_dense| (the
# same sums in another order)
PIPELINE_GRAD_TOL = 1e-5
ROW_QUANT = ("pack_rows", "scatter_rows", "relayout_rows", "pack_quant_rows", "dequant_scatter_rows")


def _grad_gap(a: dict, b: dict, dev=None) -> tuple[float, str]:
    """The largest max |a - b| / max |b| over the leaves, and its leaf;
    each pair of leaves moved to ``dev`` first where it is given."""
    gaps = {}
    for p, x in a.items():
        y = b[p] if dev is None else b[p].to(dev)
        x = x if dev is None else x.to(dev)
        gaps[p] = ((x - y).abs().max() / y.abs().max()).item()
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def row_cut_checker(commits: list, controller, rebuild):
    """A ``rebuild_state`` that holds every row (dim 0) of the state a
    commit delivered against the cut it was moved from, before any update:
    params byte for byte; under the controller's quantizing wire policy a
    moment's row either exact (a cell resident on a destination rank, which
    on one card can be the last writer of the global row) or the plain
    int8 round trip of the cut's row. Appends ``{"step", "quantized_rows":
    {name: row mask}, "check_s"}`` a commit."""
    from repro_torch.utils.pytree import tree_paths

    def checked_rebuild(named, params_like, opt_like, extras):
        t0 = time.perf_counter()
        ctrl = controller()
        policy = ctrl.wire_policy
        old = {f"params/{p}": x for p, x in tree_paths(params_like).items()}
        for coll in ("mu", "nu"):
            old.update({f"{coll}/{p}": x for p, x in tree_paths(opt_like[coll]).items()})
        rows = {}
        for name, new in named.items():
            fmt = policy.format_for(name.split("/")[0]) if policy is not None else "none"
            if new is old[name]:
                continue
            a, b = _bytes(new).reshape(new.shape[0], -1), _bytes(old[name]).reshape(new.shape[0], -1)
            exact = (a == b).all(1)
            if fmt == "none":
                assert exact.all(), f"{name}: the commit did not deliver the cut's bytes"
                continue
            q = _bytes(_round_trip_rows(old[name], fmt)).reshape(new.shape[0], -1)
            quantized = (a == q).all(1) & ~exact
            assert (exact | quantized).all(), f"{name}: a row is neither the cut's bytes nor their {fmt} round trip"
            if quantized.any():
                rows[name] = quantized.cpu()
        torch.cuda.synchronize()
        commits.append({"step": ctrl.step, "quantized_rows": rows, "check_s": time.perf_counter() - t0})
        return rebuild(named, params_like, opt_like, extras)

    return checked_rebuild


def phase_pipeline_first_step() -> None:
    """The pipelined first step (pp2tp2, 2 microbatches) against the dense
    dp2tp2 step with the same microbatches, from the run's init and first
    batch: in f32 compute (TF32 off) at ``check_layers`` layers within
    ``PIPELINE_GRAD_TOL``; at ``layers`` in bf16 compute the gap printed."""
    import gc

    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.distribution.pipeline import make_pipeline_grad_fn
    from repro_torch.distribution.step import make_grad_fn
    from repro_torch.utils.pytree import tree_paths

    full = dataclasses.replace(get_config(TRAIN["arch"]), num_layers=PIPELINE["layers"])
    batch = {"tokens": torch.from_numpy(SyntheticLM(full.vocab_size, TRAIN["seq"], TRAIN["batch"], 0)
                                        .global_batch_at(0)).to("cuda", torch.long)}
    for cfg in (dataclasses.replace(full, num_layers=PIPELINE["check_layers"], dtype="float32"), full):
        gc.collect()
        torch.cuda.empty_cache()
        params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
        loss, _, grads = make_pipeline_grad_fn(cfg, PP2TP2, 2)(params, batch)
        grads = tree_paths(grads)
        dloss, _, dense = make_grad_fn(cfg, 2)(params, batch)
        gap, leaf = _grad_gap(grads, tree_paths(dense))
        rel = abs(float(loss) - float(dloss)) / abs(float(dloss))
        log("train-pp", f"first step, {cfg.num_layers} layers, {cfg.dtype} compute: pp2tp2 (2 microbatches, the "
                        f"pipeline) against dp2tp2 (2 microbatches, explicit accumulation): loss {float(loss):.6f} / "
                        f"{float(dloss):.6f} (relative {rel:.3e}), gradients max |g - g_dense| / max |g_dense| "
                        f"{gap:.3e} at {leaf}" + (f" (tol {PIPELINE_GRAD_TOL:g})" if cfg.dtype == "float32" else ""))
        assert all(torch.isfinite(g).all() for g in grads.values())
        del grads, dense
        if cfg.dtype == "float32":
            assert gap <= PIPELINE_GRAD_TOL and rel <= PIPELINE_GRAD_TOL, "the pipelined step disagrees"
        else:
            # where a pp world's gradients cost more on one card: the
            # microbatches or the schedule. Each function once to warm,
            # then three calls timed to a sync
            fns = {"dense 1 microbatch": make_grad_fn(cfg), "dense 2": make_grad_fn(cfg, 2),
                   "pp2 2 (scan_loss)": make_pipeline_grad_fn(cfg, PP2TP2, 2)}
            grad_s = {}
            for label, fn in fns.items():
                times = []
                for _ in range(4):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = fn(params, batch)
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
                    del out
                grad_s[label] = times[1:]
            log("train-pp", f"the gradients alone, {cfg.num_layers} layers, bf16 compute (host clock, three calls after a warm-up, "
                            "median [min, max]): " + ", ".join(f"{k} {statistics.median(v):.4f} s [{min(v):.4f}, "
                                                               f"{max(v):.4f}]" for k, v in grad_s.items()))
        del params
    gc.collect()
    torch.cuda.empty_cache()


def _world_control(cfg, opt, plan, roundtrip=None) -> tuple[dict, list]:
    """The control of a resized run: for each ``(steps, parallel)`` of
    ``plan`` the world's step (``build_train_world``) run ``steps`` times on
    the controller's data, the state handed on by plain tensor copies; the
    moment rows ``roundtrip = (step, {name: row mask})`` names
    round-tripped through the plain int8 wire after ``step`` steps.
    Returns (params, losses)."""
    import gc

    from repro_torch.core.shadow import build_train_world
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.distribution.step import init_train_state
    from repro_torch.utils.pytree import tree_from_paths, tree_paths

    params, opt_state = init_train_state(cfg, 0, "none", "cuda")
    data = SyntheticLM(cfg.vocab_size, TRAIN["seq"], TRAIN["batch"], 0)
    losses: list[float] = []
    for steps, parallel in plan:
        world = build_train_world(cfg, parallel, opt, TRAIN["batch"], TRAIN["seq"],
                                  devices=["cuda"] * parallel.world_size)
        params = tree_from_paths({p: x.clone() for p, x in tree_paths(params).items()})
        opt_state = tree_from_paths({p: x.clone() for p, x in tree_paths(opt_state).items()})
        gc.collect()
        for _ in range(steps):
            if roundtrip is not None and len(losses) == roundtrip[0]:
                with torch.no_grad():
                    for coll in ("mu", "nu"):
                        for p, x in tree_paths(opt_state[coll]).items():
                            mask = roundtrip[1].get(f"{coll}/{p}")
                            if mask is not None:
                                x[mask.to(x.device)] = _round_trip_rows(x, "int8")[mask.to(x.device)]
            batch = {"tokens": torch.from_numpy(data.global_batch_at(len(losses))).to("cuda", torch.long)}
            params, opt_state, m = world.step_fn(params, opt_state, batch)
            losses.append(float(m["loss"]))
        del world
    return params, losses


def phase_train_pipeline() -> dict:
    """Pipeline-parallel training at full width, resized out of and into
    pp (see the module docstring, 38). Returns the path's launches."""
    import gc

    from repro_torch.core import controller as C
    from repro_torch.core.controller import LiveRController
    from repro_torch.optim import AdamWConfig
    from repro_torch.reshard import WirePolicy
    from repro_torch.utils.pytree import tree_paths

    phase_pipeline_first_step()
    cfg = dataclasses.replace(get_config(TRAIN["arch"]), num_layers=PIPELINE["layers"])
    opt = AdamWConfig(learning_rate=1e-4, warmup_steps=2, total_steps=1000)
    kw = dict(seq_len=TRAIN["seq"], global_batch=TRAIN["batch"], device="cuda", stream_k=PIPELINE["stream_k"])
    commits: list[dict] = []
    windows: list[dict] = []
    orig_rebuild = C.rebuild_state
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    C.rebuild_state = row_cut_checker(commits, lambda: ctrl, orig_rebuild)
    try:
        ctrl = LiveRController(cfg, PP2TP2, opt, overlap="stream", wire_policy=WirePolicy(), **kw)
        _zero_counts()  # the pipeline path's counts start here ...
        launches: dict = {}
        t_run = time.perf_counter()
        losses = ctrl.train_steps(PIPELINE["before"])
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        for target, overlap in ((DP2TP2, "stream"), (PP4TP1, "stop_copy")):
            if overlap == "stop_copy":
                ctrl.wire_policy = None  # the second resize is lossless
                losses += ctrl.train_steps(PIPELINE["between"])
            before = dict(_all_counts())
            torch.cuda.synchronize()
            peak_gb = max(peak_gb, torch.cuda.max_memory_allocated() / 1e9)
            torch.cuda.reset_peak_memory_stats()
            ctrl.request_resize(target, overlap=overlap)
            n = len(ctrl.records)
            while len(ctrl.records) == n:
                losses += ctrl.train_steps(1)
                assert len(losses) < 200, f"the resize to {target.describe()} never committed"
            after = _all_counts()
            windows.append({"launched": {k: after[k] - before[k] for k in ROW_QUANT},
                            "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
        losses += ctrl.train_steps(PIPELINE["after"])
        run_s = time.perf_counter() - t_run
        _take_counts(launches)  # ... and are read here
    finally:
        C.rebuild_state = orig_rebuild
    peak_gb = max([peak_gb, torch.cuda.max_memory_allocated() / 1e9] + [w["peak_gb"] for w in windows])
    log("train-pp", f"{cfg.name} full width ({cfg.num_layers} layers, fp32 params, {cfg.dtype} compute), "
                    f"batch {TRAIN['batch']} x {TRAIN['seq']}: pp2tp2 -> dp2tp2 (stream, int8 moments) -> pp4tp1 "
                    f"(stop-copy, lossless): {len(losses)} steps in {run_s:.1f}s, losses "
                    f"{[round(x, 4) for x in losses]}, launches {launches}")
    assert all(np.isfinite(losses)), "a loss is not finite"
    assert [r.dst for r in ctrl.records] == [DP2TP2.describe(), PP4TP1.describe()], [r.dst for r in ctrl.records]
    for i, (rec, c, w) in enumerate(zip(ctrl.records, commits, windows)):
        pause_s = rec.total_pause_s - c["check_s"]  # the smoke's own check is not the system's pause
        log("train-pp", f"commit {i + 1} {rec.mode} {rec.src} -> {rec.dst} at step {c['step']}: pause_s "
                        f"{pause_s:.4f}, prepare_s {rec.prepare_s:.4f}, executed {rec.executed_bytes / 1e9:.4f} GB "
                        f"against the plan's {(rec.plan_network_bytes + rec.plan_local_bytes) / 1e9:.4f} GB (wire "
                        f"{rec.wire_bytes / 1e9:.4f}, logical {rec.logical_bytes / 1e9:.4f}), dirty layers "
                        f"{rec.dirty_layers}/{rec.layers_total}, rows the int8 wire delivered "
                        f"{sum(int(m.sum()) for m in c['quantized_rows'].values())} of "
                        f"{sum(m.numel() for m in c['quantized_rows'].values())} in {len(c['quantized_rows'])} "
                        f"tensors (the rest resident, exact); row and quant launches {w['launched']}; peak memory "
                        f"{w['peak_gb']:.2f} GB")
        assert rec.generic_cells == 0 and rec.executed_bytes > 0
        assert w["launched"]["pack_rows"] == w["launched"]["scatter_rows"] > 0, w["launched"]
    first, second = commits
    assert first["quantized_rows"] and all(n.split("/")[0] in ("mu", "nu") for n in first["quantized_rows"])
    assert windows[0]["launched"]["pack_quant_rows"] == windows[0]["launched"]["dequant_scatter_rows"] > 0
    assert not second["quantized_rows"] and windows[1]["launched"]["pack_quant_rows"] == 0
    # each world's steps (host clock): those without a commit, the first
    # step of the run left out
    worlds = ([PP2TP2] * (first["step"] + 1) + [DP2TP2] * (second["step"] - first["step"] - 1)
              + [PP4TP1] * (len(losses) - second["step"]))
    # a pp world's step runs each layer once a microbatch (max(1, pp) of
    # them), forward twice (remat) and backward once; every launch on the
    # tensor cores
    mbs = {PP2TP2: 2, DP2TP2: 1, PP4TP1: 4}
    layer_passes = cfg.num_layers * sum(mbs[p] for p in worlds)
    assert launches["flash_attention"] == 2 * layer_passes and launches["flash_attention_bwd"] == layer_passes, launches
    assert launches["flash_attention_tc"] == launches["flash_attention"], launches
    assert launches["flash_attention_bwd_tc"] == launches["flash_attention_bwd"], launches
    commit_steps = {first["step"], second["step"] - 1}
    step_s = {}
    for p in (PP2TP2, DP2TP2, PP4TP1):
        ts = [t for i, t in enumerate(ctrl.iteration_times) if worlds[i] == p and i and i not in commit_steps]
        step_s[_short(p)] = (statistics.median(ts), len(ts))
    log("train-pp", "step_s side by side (host clock, median, steps without a commit): "
                    + ", ".join(f"{k} {v[0]:.4f} s over {v[1]} steps" for k, v in step_s.items())
                    + f"; peak memory {peak_gb:.2f} GB")
    final = {p: x.clone() for p, x in tree_paths(ctrl.params).items()}
    del ctrl
    gc.collect()
    torch.cuda.empty_cache()

    plan = [(first["step"] + 1, PP2TP2), (second["step"] - first["step"] - 1, DP2TP2),
            (len(losses) - second["step"], PP4TP1)]
    params, c_losses = _world_control(cfg, opt, plan, roundtrip=(first["step"], first["quantized_rows"]))
    unequal = [p for p, x in tree_paths(params).items() if not torch.equal(x, final[p])]
    log("train-pp", f"params after the run against the control that takes the same worlds at the same steps "
                    f"({', '.join(f'{n} on {_short(p)}' for n, p in plan)}) and carries the state by plain tensor "
                    f"copies: {len(final) - len(unequal)} of {len(final)} tensors bitwise equal; losses equal "
                    f"{c_losses == losses}")
    assert not unequal, f"the resized run's params differ from the control's: {unequal[:4]}"
    assert c_losses == losses, "the resized run's losses differ from the control's"
    del params, final
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# int8 error-feedback gradient compression (phase 39): qwen3-1.7b as in
# TRAIN, 3 steps on dp2tp2, a stop-copy to dp1tp4, 2 more steps. The
# state, the ef buffers, the gradients and the stop-copy's destination
# tensors peak near 71 GB, so the phase runs right after phase 13, before
# later phases leave the caching allocator fragmented
INT8_EF = dict(before=3, after=2)


def _ef_digests(ctrl) -> dict:
    from repro_torch.utils.pytree import tree_paths

    ef = tree_paths(ctrl.opt_state["ef"])
    return dict(zip(ef, map(tuple, torch.stack([_shard_digest(x) for x in ef.values()]).tolist())))


def phase_train_int8_ef() -> dict:
    """Training under ``compression="int8_ef"`` at full width, resized by
    stop-copy (see the module docstring, 39). Returns the path's
    launches."""
    import gc

    from repro_torch.core import controller as C
    from repro_torch.core.controller import LiveRController
    from repro_torch.optim import AdamWConfig
    from repro_torch.utils.pytree import tree_paths

    cfg = get_config(TRAIN["arch"])
    opt = AdamWConfig(learning_rate=1e-4, warmup_steps=2, total_steps=1000)
    kw = dict(seq_len=TRAIN["seq"], global_batch=TRAIN["batch"], device="cuda", compression="int8_ef")
    at_cut: dict = {}
    orig_rebuild = C.rebuild_state

    def rebuild(named, params_like, opt_like, extras):
        at_cut.update(step=ctrl.step, ptrs={p: x.data_ptr() for p, x in tree_paths(extras["ef"]).items()})
        return orig_rebuild(named, params_like, opt_like, extras)

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    C.rebuild_state = rebuild
    try:
        ctrl = LiveRController(cfg, DP2TP2, opt, **kw)
        _zero_counts()  # the int8_ef path's counts start here ...
        launches: dict = {}
        t_run = time.perf_counter()
        losses = ctrl.train_steps(INT8_EF["before"])
        ctrl.request_resize(ParallelConfig(dp=1, tp=4))
        while not ctrl.records:
            losses += ctrl.train_steps(1)
            assert len(losses) < 200, "the stop-copy resize never committed"
        cut = _ef_digests(ctrl)
        moved = {p: x.data_ptr() for p, x in tree_paths(ctrl.opt_state["ef"]).items()}
        losses += ctrl.train_steps(INT8_EF["after"])
        run_s = time.perf_counter() - t_run
        _take_counts(launches)  # ... and are read here
    finally:
        C.rebuild_state = orig_rebuild
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rec = ctrl.records[0]
    ef_gb = sum(x.numel() * 4 for x in tree_paths(ctrl.opt_state["ef"]).values()) / 1e9
    end = _ef_digests(ctrl)
    log("train-ef", f"{cfg.name} full width and depth ({cfg.num_layers} layers), compression int8_ef (ef "
                    f"{ef_gb:.2f} GB fp32), batch "
                    f"{TRAIN['batch']} x {TRAIN['seq']}: dp2tp2 -> dp1tp4 (stop-copy) at step {at_cut['step']}: "
                    f"{len(losses)} steps in {run_s:.1f}s, losses {[round(x, 4) for x in losses]}; commit pause_s "
                    f"{rec.total_pause_s:.4f}, prepare_s {rec.prepare_s:.4f}, executed {rec.executed_bytes / 1e9:.4f} "
                    f"GB; ef passed through the commit uncounted: {moved == at_cut['ptrs']}; peak memory "
                    f"{peak_gb:.2f} GB; launches {launches}")
    plain_steps = [t for i, t in enumerate(ctrl.iteration_times) if i and i != at_cut["step"] - 1]
    log("train-ef", f"step time on the card (host clock, steps without a commit, the first left out): median "
                    f"{statistics.median(plain_steps):.4f} s over {len(plain_steps)} steps")
    assert all(np.isfinite(losses)), "a loss is not finite"
    assert launches["flash_attention"] == 2 * cfg.num_layers * len(losses) == 2 * launches["flash_attention_bwd"]
    assert launches["flash_attention_tc"] == launches["flash_attention"], launches
    assert moved == at_cut["ptrs"], "the commit moved the error-feedback buffers"
    assert any(d != (0, 0) for d in cut.values()), "the error-feedback buffers are zero"
    del ctrl
    gc.collect()
    torch.cuda.empty_cache()

    control = LiveRController(cfg, DP2TP2, opt, **kw)
    c_losses = control.train_steps(at_cut["step"])
    c_cut = _ef_digests(control)
    c_losses += control.train_steps(len(losses) - at_cut["step"])
    c_end = _ef_digests(control)
    log("train-ef", f"against a control never resized: ef digests at the commit's step equal {c_cut == cut}, after "
                    f"the run equal {c_end == end}; losses equal {c_losses == losses}")
    assert c_cut == cut and c_end == end, "the error-feedback buffers differ from the control's"
    assert c_losses == losses, "the losses differ from the control's"
    del control
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Slice 18: the dry run on the meta device held against the card's own
# worlds; the torch examples on the card
# ---------------------------------------------------------------------------

LLAMA4 = "llama4-scout-17b-a16e"
CARD_MESH = MeshSpec(("data", "model"), (1, 1))  # a one-card world's mesh
CARD_TRAIN = ShapeConfig("card_train", TRAIN["seq"], TRAIN["batch"], "train")  # phase 13's world
CARD_TRAIN_OPTS = {"microbatches": 1}
CARD_PREFILL = ShapeConfig("card_prefill", SERVE["prompt_len"], SERVE["batch"], "prefill")  # phase 5's
CARD_PREFILL_OPTS = {"served_dtype": "bfloat16", "max_seq": SERVE["prompt_len"] + SERVE["gen"]}
DRYRUN_REPS = 4  # steps (prefills) run in each rebuilt world; the first is not timed
EXAMPLES = [("quickstart_torch.py",), ("reshard_demo_torch.py",), ("fleet_train_torch.py",)]
EXAMPLE_TIMEOUT_S = 300
# the tensors of the worlds phases 5 and 13 built, by leaf, and their own
# measured times and peaks; phase 40 reads them
CARD_WORLDS: dict = {}


def leaf_bytes(**trees) -> dict[str, int]:
    """``{"<tree>/<leaf path>": bytes}`` of every tensor of the trees."""
    from repro_torch.utils.pytree import tree_paths

    return {f"{name}/{path}": x.numel() * x.element_size()
            for name, tree in trees.items() for path, x in tree_paths(tree).items()}


def check_world_bytes(phase: str, what: str, leaves: dict, cfg, shape, opts: dict) -> int:
    """Hold a world's tensors, leaf by leaf, to the dry run's per-chip
    argument bytes on a one-card mesh; returns their sum."""
    from repro_torch.launch import dryrun

    _, _, predicted, _ = dryrun.build_cell(cfg, shape, CARD_MESH, opts)
    differ = sorted((p, predicted.get(p), leaves.get(p)) for p in set(predicted) | set(leaves)
                    if predicted.get(p) != leaves.get(p))
    log(phase, f"{what}: the dry run's argument bytes {sum(predicted.values())} over {len(predicted)} leaves, "
               f"the world's tensors {sum(leaves.values())} over {len(leaves)} leaves; equal leaf by leaf: "
               f"{not differ}")
    assert not differ, differ[:10]
    return sum(predicted.values())


def _timed_reps(fn) -> tuple[float, float]:
    """(median seconds of ``fn`` over the reps after the first, the peak
    memory in bytes over all of them)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(DRYRUN_REPS):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times[1:]), torch.cuda.max_memory_allocated()


def _log_prediction(what: str, pred: dict, args: int, peak: int, seconds: float, phase_numbers: str) -> None:
    predicted_peak = args + pred["memory_analysis"]["temp_size_in_bytes"]
    log("dryrun", f"{what}: predicted peak {predicted_peak / 1e9:.3f} GB (arguments {args / 1e9:.3f} + the step's own "
                  f"{pred['memory_analysis']['temp_size_in_bytes'] / 1e9:.3f}) against max_memory_allocated "
                  f"{peak / 1e9:.3f} GB, ratio {predicted_peak / peak:.3f}; compute term {pred['compute_s']:.4f} s "
                  f"({pred['hlo_flops'] / 1e12:.2f} TFLOP), memory term {pred['memory_s']:.4f} s "
                  f"({pred['hlo_bytes'] / 1e9:.1f} GB), bottleneck {pred['bottleneck']}, against the measured "
                  f"{seconds:.4f} s (terms / measured {max(pred['compute_s'], pred['memory_s']) / seconds:.3f}); "
                  f"{phase_numbers}; counted in {pred['counts']['seconds']:.2f} s over {pred['counts']['ops']} ops")


def phase_dryrun_card() -> dict:
    """The dry run of qwen3-1.7b's own worlds on a one-card mesh (see the
    module docstring, 40): the argument bytes against the worlds' tensors,
    the peak and the roofline terms against the measured ones; then the
    sweep of qwen3-1.7b's cells on both production meshes."""
    import gc

    from repro_torch.configs import SHAPES
    from repro_torch.distribution.step import init_train_state, make_train_step
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import HBM_BYTES
    from repro_torch.optim import AdamWConfig

    t_phase = time.perf_counter()
    cfg = get_config("qwen3-1.7b")
    out = {}
    gc.collect()
    torch.cuda.empty_cache()

    # the training world: phase 13's controller's tensors, then the same world
    # rebuilt here and stepped alone
    pred = dryrun.dry_run(cfg, CARD_TRAIN, CARD_MESH, CARD_TRAIN_OPTS)
    train = CARD_WORLDS["train"]
    args = check_world_bytes("dryrun", "train world (phase 13's controller at its start)", train["leaves"], cfg,
                             CARD_TRAIN, CARD_TRAIN_OPTS)
    assert args == pred["memory_analysis"]["argument_size_in_bytes"]
    params, opt_state = init_train_state(cfg, seed=0, device="cuda")
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (TRAIN["batch"], TRAIN["seq"]), device="cuda")}
    check_world_bytes("dryrun", "train world rebuilt here", leaf_bytes(params=params, opt=opt_state, batch=batch),
                      cfg, CARD_TRAIN, CARD_TRAIN_OPTS)
    step = make_train_step(cfg, AdamWConfig(learning_rate=1e-4, warmup_steps=2, total_steps=1000))
    _zero_counts()
    step_s, peak = _timed_reps(lambda: step(params, opt_state, batch))
    launched = {"flash_attention": fa.launches // DRYRUN_REPS, "flash_attention_bwd": fa.bwd_launches // DRYRUN_REPS}
    counted = {k: v["launches"] for k, v in pred["counts"]["kernels"].items()}
    log("dryrun", f"train world: kernel launches a step counted on meta {counted}, on the card {launched}")
    assert counted == launched, (counted, launched)
    _log_prediction(f"train world {TRAIN['batch']} x {TRAIN['seq']}", pred, args, peak, step_s,
                    f"phase 13's own: peak {train['peak_gb']:.2f} GB (predicted / it "
                    f"{(args + pred['memory_analysis']['temp_size_in_bytes']) / 1e9 / train['peak_gb']:.3f}), "
                    f"median step {train['step_s']:.4f} s")
    out["train"] = dict(args=args, peak=peak, step_s=step_s, pred=pred)
    del params, opt_state, batch, step
    gc.collect()
    torch.cuda.empty_cache()

    # the serving world: phase 5's tensors, then rebuilt and prefilled alone
    pred = dryrun.dry_run(cfg, CARD_PREFILL, CARD_MESH, CARD_PREFILL_OPTS)
    serve = CARD_WORLDS["prefill"]
    args = check_world_bytes("dryrun", "prefill world (phase 5's served weights and prompts)", serve["leaves"], cfg,
                             CARD_PREFILL, CARD_PREFILL_OPTS)
    assert args == pred["memory_analysis"]["argument_size_in_bytes"]
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda", served_dtype=cfg.dtype)
    batch = demo_batch(cfg, SERVE["batch"], SERVE["prompt_len"])
    check_world_bytes("dryrun", "prefill world rebuilt here", leaf_bytes(params=params, batch=batch), cfg,
                      CARD_PREFILL, CARD_PREFILL_OPTS)

    def prefill():
        with torch.inference_mode():
            M.prefill(cfg, params, batch, max_seq=CARD_PREFILL_OPTS["max_seq"])

    _zero_counts()
    prefill_s, peak = _timed_reps(prefill)
    assert pred["counts"]["kernels"]["flash_attention"]["launches"] == fa.launches // DRYRUN_REPS == cfg.num_layers
    _log_prediction(f"prefill world {SERVE['batch']} x {SERVE['prompt_len']}", pred, args, peak, prefill_s,
                    f"phase 5's own: prefill_s {serve['prefill_s']:.4f} (its first prefill), serve_once peak "
                    f"{serve['peak_gb']:.2f} GB")
    out["prefill"] = dict(args=args, peak=peak, prefill_s=prefill_s, pred=pred)
    del params, batch
    gc.collect()
    torch.cuda.empty_cache()

    # the sweep of qwen3-1.7b's cells on both production meshes, in-process
    for multi_pod in (False, True):
        for shape_name in SHAPES:
            r = dryrun._run_cell(cfg.name, shape_name, multi_pod)
            assert r["status"] in ("ok", "skipped"), r
            if r["status"] == "skipped":
                log("dryrun", f"sweep {cfg.name} x {shape_name} ({r['mesh']}): skipped, {r['reason']}")
                continue
            arg = r["memory_analysis"]["argument_size_in_bytes"]
            log("dryrun", f"sweep {cfg.name} x {shape_name} ({r['mesh']}, {r['chips']} H100s): arguments "
                          f"{arg / 1e9:.3f} GB a chip ({'fit' if arg <= HBM_BYTES else 'do not fit'} in 80 GB), "
                          f"{r['hlo_flops'] / 1e15:.3f} PFLOP and {r['hlo_bytes'] / 1e12:.3f} TB in all, compute "
                          f"{r['compute_s']:.5f} s, memory {r['memory_s']:.5f} s, bottleneck {r['bottleneck']} (no "
                          f"collective term), useful FLOPs {r['useful_flops_ratio']:.3f}; {r['total_s']:.1f} s")
    log("dryrun", f"phase {time.perf_counter() - t_phase:.1f}s")
    return out


def phase_examples() -> None:
    """The three torch examples (quickstart, reshard demo, fleet), each a
    subprocess on the card with a time limit, the three at once (they are
    small; the fleet example's live job waits on its trace's clock); a
    non-zero exit fails."""
    import gc
    import os

    gc.collect()
    torch.cuda.empty_cache()
    root = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    procs = [(script, subprocess.Popen([sys.executable, str(root / "examples" / script), *args], cwd=root,
                                       env=dict(os.environ), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                       text=True))
             for script, *args in EXAMPLES]
    failed = []
    for script, proc in procs:
        try:
            out, err = proc.communicate(timeout=max(1.0, EXAMPLE_TIMEOUT_S - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
            err += f"\n{script}: killed at the {EXAMPLE_TIMEOUT_S} s limit"
        lines = out.strip().splitlines()
        log("examples", f"{script} on the card: exit {proc.returncode} by {time.perf_counter() - t0:.1f}s; "
                        + " | ".join(x.strip() for x in lines[-3:]))
        if proc.returncode != 0:
            failed.append((script, err[-3000:]))
    assert not failed, failed


# phase 42: per-rank worlds on the one card (see the module docstring)
# 2 of qwen3's 28 layers, 1 + 1 + 1 steps besides the commits' and every
# layer in one pre-copy round (8 layers, 3 + 2 + 2 steps and rounds of 4
# before phase 43 came), to keep the script's time
RANK_TRAIN = dict(layers=2, nproc=4, batch=4, seq=1024, before=1, between=1, after=1, stream_k=8, device="cuda")
# the first step's f32 gradients against the one-process world's: the limit
# phase 31 holds a deep model's first step to against the plain attention
# (at 8 layers of full width the summation orders of tp's partial products
# part the two by 1.15e-5 of a leaf's largest entry, past phase 35's 1e-5
# at one layer)
RANK_GRAD_TOL = SEAMLESS_GRAD_TOL
# the first step in bf16 compute: the per-rank gradients may stand at most
# this many times as far from the f32 one-process gradients as the
# one-process bf16 gradients stand from them
RANK_BF16_FACTOR = 2.0
# the JAX package's RESHAPE_PARITY_TOL (tests/conftest.py)
RANK_PARITY_TOL = 1e-2
# where the int8 commit's moments broke Adam's |mu| <= sqrt(nu), the
# resized run's params may part from the control's by at most this many
# times what a summation order alone parts two sound runs by there
RANK_MASKED_FACTOR = 2.0
# a lossless commit's destination world, by its steps where the bound
# held (``_step_gap``): the run's move less the control's, over the
# control's move; a world that skips its update reads 1
RANK_STEP_TOL = 1e-2
RANK_KERNELS = ("flash_attention", "flash_attention_bwd", "pack_rows", "scatter_rows", "relayout_rows",
                "pack_quant_rows", "dequant_scatter_rows")


# the resized run trains in f32 compute: in bf16 Adam multiplies the
# gradients' rounding gap where the int8 wire zeroed a nu entry (0.54 in
# the params after 12 steps on an H100 80GB HBM3 at 700 W); the bf16
# per-rank step is held on the first step
def _rank_cfg(dtype: str = "float32"):
    return dataclasses.replace(get_config(TRAIN["arch"]), num_layers=RANK_TRAIN["layers"], dtype=dtype)


def _card_used_gb() -> float:
    if RANK_TRAIN["device"] != "cuda":
        return 0.0
    free, total = torch.cuda.mem_get_info()
    return (total - free) / 1e9


def _rank_data():
    from repro_torch.data import SyntheticLM

    return SyntheticLM(_rank_cfg().vocab_size, RANK_TRAIN["seq"], RANK_TRAIN["batch"], 0)


def _rank_references() -> dict:
    """Rank 0 alone, before the world: the one-process first step's loss
    and gradients on the host, in f32 and in bf16 compute, and the bf16
    step's gaps from the f32 one and from a sound twin that sums the
    batch's rows in two halves (microbatches 2: only the order differs)."""
    from repro_torch.distribution.step import make_grad_fn
    from repro_torch.utils.pytree import tree_paths

    dev = RANK_TRAIN["device"]
    params = M.init_params(_rank_cfg(), torch.Generator(device=dev).manual_seed(0), dev)
    batch = {"tokens": torch.from_numpy(_rank_data().global_batch_at(0)).to(dev, torch.long)}
    out = {}
    for dtype, mb in (("float32", 1), ("bfloat16", 1), ("bf16_halves", 2)):
        loss, _, grads = make_grad_fn(_rank_cfg("float32" if dtype == "float32" else "bfloat16"), mb)(params, batch)
        out[dtype] = (float(loss), {f"params/{p}": g.cpu() for p, g in tree_paths(grads).items()})
        del grads
    out["bf16_vs_f32"] = _grad_gap(out["bfloat16"][1], out["float32"][1], dev)
    out["bf16_order"] = _grad_gap(out.pop("bf16_halves")[1], out["bfloat16"][1], dev)
    del params
    torch.cuda.empty_cache()
    return out


def _split_gaps(got: dict, want: dict, mask: dict, dev) -> dict:
    """``got`` against ``want`` (tensors by name): the largest |diff| where
    ``mask`` is false ("kept") and where it is true ("masked"), each with
    its leaf, the entries past 1e-2, and how many of those lie in the mask."""
    out = {"kept": (0.0, ""), "masked": (0.0, ""), "past": 0, "past_in_mask": 0}
    for n, w in want.items():
        d = (got[n].to(dev) - w.to(dev)).abs()
        m = mask[n].to(dev)
        far = d > 1e-2
        out["past"] += int(far.sum())
        out["past_in_mask"] += int((far & m).sum())
        out["kept"] = max(out["kept"], (d.masked_fill(m, 0).max().item(), n))
        out["masked"] = max(out["masked"], (d.masked_fill(~m, 0).max().item(), n))
        del d, m, far
    return out


def _step_gap(a1: dict, a0: dict, c1: dict, c0: dict, mask: dict, dev) -> tuple:
    """How far a run's params moved from where the control's moved over
    the same steps, as a share of the control's move, where ``mask`` is
    false: the largest over leaves of ||(a1 - a0) - (c1 - c0)|| / ||c1 -
    c0|| (tensors by name, any device; on the card in slices of 2**26
    entries), with its leaf. A world that skips its update reads 1."""
    worst = (0.0, "")
    for n in c1:
        num = den = 0.0
        flat = [t[n].reshape(-1) for t in (a1, a0, c1, c0)] + [mask[n].reshape(-1)]
        for lo in range(0, flat[0].numel(), 1 << 26):
            x1, x0, y1, y0, m = (t[lo:lo + (1 << 26)].to(dev) for t in flat)
            dc = (y1 - y0).masked_fill_(m, 0)
            num += float(torch.square((x1 - x0).masked_fill_(m, 0).sub_(dc)).sum(dtype=torch.float64))
            den += float(torch.square(dc).sum(dtype=torch.float64))
            del x1, x0, y1, y0, m, dc
        worst = max(worst, (math.sqrt(num / den) if den else (0.0 if num == 0 else math.inf), n))
    return worst


def _rank_controls(opt, steps: int, cuts: list, final: dict, dev, cfg=None, par=ParallelConfig(dp=2, tp=2),
                   microbatches: int = 1, twin_par=ParallelConfig(dp=2, tp=2)) -> dict:
    """Rank 0 alone, after the resized run. The control: the one-process
    ``par`` world never resized (``microbatches``), ``steps`` steps; at
    each commit's step (``cuts``) it takes the moments an int8 commit
    delivered in place of its own (the same wire round trip at the same
    step, as phase 13's control takes it). The witness: from the control's
    state at the int8 commit, the one-process ``twin_par`` world with the
    batch's rows summed in two halves (microbatches 2), a sound run that
    differs from the control only in summation order. The mask: the entries
    where the delivered moments broke Adam's |mu| <= sqrt(nu) (the wire
    rounds a small nu to 0 beside a nonzero mu; there Adam divides by
    ~eps); empty, and no witness, where no commit was int8. Each comparison
    is split by the mask (``_split_gaps``). Each commit's destination world
    is read by its steps, from the commit to the next one or the end, where
    the mask is false (``_step_gap``, by the commit's step: the run's
    against the control in ``run_steps``, the witness's in
    ``witness_steps``). After an int8 commit the broken entries make the
    control's path part from the run's; so a lossless commit after one
    (a cut with ``seat``) gets its own control, seated on the run's whole
    state at the cut, whose steps the run's are held to (``seated_steps``:
    the same start, so only the world's steps differ)."""
    from repro_torch.core.controller import LiveRController
    from repro_torch.utils.pytree import tree_from_paths, tree_paths

    cfg = cfg or _rank_cfg()
    moments = next((c["moments"] for c in cuts if c["moments"]), {})
    mask = {f"params/{n[3:]}": (x.abs() > moments[f"nu/{n[3:]}"].sqrt()).to(dev)
            for n, x in moments.items() if n.startswith("mu/")}
    named = lambda c: {f"params/{p}": x for p, x in tree_paths(c.params).items()}  # noqa: E731
    ctrl = LiveRController(cfg, par, opt, RANK_TRAIN["seq"], RANK_TRAIN["batch"], device=dev,
                           microbatches=microbatches)
    if not mask:
        mask = {n: torch.zeros(x.shape, dtype=torch.bool, device=dev) for n, x in named(ctrl).items()}
    losses, snap, later = [], None, {}
    res = {"run_at_cut": {}, "witness_at_cut": {}, "run_steps": {}, "witness_steps": {}, "seated_steps": {}}
    prev = None  # the last cut's step, the run's params there and the control's
    for cut in cuts:
        losses += ctrl.train_steps(cut["step"] - ctrl.step)
        for coll in ("mu", "nu"):
            for p, x in tree_paths(ctrl.opt_state[coll]).items():
                if f"{coll}/{p}" in cut["moments"]:
                    x.copy_(cut["moments"][f"{coll}/{p}"])
        now = named(ctrl)
        res["run_at_cut"][cut["step"]] = _split_gaps(cut["params"], now, mask, dev)
        if prev is not None:
            res["run_steps"][prev[0]] = _step_gap(cut["params"], prev[1], now, prev[2], mask, dev)
        prev = (cut["step"], cut["params"], {n: x.clone() for n, x in now.items()})
        if snap is None and cut["moments"]:
            snap = (ctrl.step, {p: x.cpu() for p, x in tree_paths(ctrl.params).items()},
                    {c: {p: x.cpu() for p, x in tree_paths(ctrl.opt_state[c]).items()} for c in ("mu", "nu")},
                    ctrl.opt_state["count"].clone())
        elif snap is not None:
            later[cut["step"]] = prev[2]
    losses += ctrl.train_steps(steps - ctrl.step)
    want_final = {n: x.clone() for n, x in named(ctrl).items()}
    res.update(control_losses=losses, control_step_s=statistics.median(ctrl.iteration_times[1:]),
               run_final=_split_gaps(final, want_final, mask, dev))
    if prev is not None:
        res["run_steps"][prev[0]] = _step_gap(final, prev[1], want_final, prev[2], mask, dev)
    del ctrl, prev
    torch.cuda.empty_cache()

    for i, cut in enumerate(cuts):
        if "seat" not in cut:
            continue
        end, want = (cuts[i + 1]["step"], cuts[i + 1]["params"]) if i + 1 < len(cuts) else (steps, final)
        seated = LiveRController(cfg, par, opt, RANK_TRAIN["seq"], RANK_TRAIN["batch"], device=dev,
                                 microbatches=microbatches,
                                 params=tree_from_paths({n[len("params/"):]: x for n, x in cut["params"].items()}))
        for c in ("mu", "nu"):
            for p, x in tree_paths(seated.opt_state[c]).items():
                x.copy_(cut["seat"][f"{c}/{p}"])
        seated.opt_state["count"].fill_(cut["step"])  # one update a step
        seated.step = cut["step"]
        seated.train_steps(end - seated.step)
        res["seated_steps"][cut["step"]] = _step_gap(want, cut["params"], named(seated), cut["params"], mask, dev)
        del seated
        torch.cuda.empty_cache()

    res["masked_entries"] = sum(int(m.sum()) for m in mask.values())
    if snap is None:
        del mask, want_final
        return res
    step0, params, opt_state, count = snap
    twin = LiveRController(cfg, twin_par, opt, RANK_TRAIN["seq"], RANK_TRAIN["batch"], device=dev,
                           microbatches=2, params=tree_from_paths(params))
    for c in ("mu", "nu"):
        for p, x in tree_paths(twin.opt_state[c]).items():
            x.copy_(opt_state[c][p])
    twin.opt_state["count"].copy_(count)
    twin.step = step0
    start = {f"params/{p}": x for p, x in params.items()}
    at = (step0, start, start)  # the witness's last cut: its step, the twin's params there and the control's
    for step, want in [*later.items(), (steps, want_final)]:
        twin.train_steps(step - twin.step)
        now = named(twin)
        res["witness_steps"][at[0]] = _step_gap(now, at[1], want, at[2], mask, dev)
        if step < steps:
            res["witness_at_cut"][step] = _split_gaps(now, want, mask, dev)
            at = (step, {n: x.clone() for n, x in now.items()}, want)
    res["witness_final"] = _split_gaps(named(twin), want_final, mask, dev)
    del twin, later, want_final, mask, at
    torch.cuda.empty_cache()
    return res


def _cut_check(a: torch.Tensor, b: torch.Tensor, dev) -> tuple:
    """Rank 0's check of one rounded tensor of a commit's cut, the old
    world's ``a`` against the new world's ``b`` (both whole on the host),
    on the card in slices of 2**26 entries: (max |a|, max |b - a|, entries
    of ``a`` nonzero and of them zero in ``b``)."""
    amax, err, nonzero, zeroed = 0.0, 0.0, 0, 0
    fa, fb = a.reshape(-1), b.reshape(-1)
    for lo in range(0, fa.numel(), 1 << 26):
        x, y = fa[lo:lo + (1 << 26)].to(dev), fb[lo:lo + (1 << 26)].to(dev)
        amax = max(amax, x.abs().max().item())
        err = max(err, (y - x).abs().max().item())
        nonzero += int((x != 0).sum())
        zeroed += int(((y == 0) & (x != 0)).sum())
    return amax, err, nonzero, zeroed


def _world_digests(named: dict, parallel, specs, rank: int, dev) -> list:
    """Each tensor's :func:`_shard_digest` summed over ``parallel``'s ranks,
    each distinct view counted once (its lowest rank's), on every rank of
    the pool: one all-reduce."""
    import torch.distributed as dist

    from repro_torch.core.resource_view import view_of

    out = torch.zeros((len(specs), 2), dtype=torch.int64, device=dev)
    for i, spec in enumerate(specs):
        view = view_of(spec, parallel, rank) if rank < parallel.world_size else None
        if view is not None and rank == min(r for r in range(parallel.world_size)
                                            if (v := view_of(spec, parallel, r)) is not None and v == view):
            out[i] = _shard_digest(named[spec.name], spec, view)
    out = out.cpu()
    dist.all_reduce(out)
    return [tuple(d) for d in out.tolist()]


def _checked_controller(dev, checks: list, cuts: list):
    """``RankController`` that holds each commit's cut, before any update:
    every tensor the wire does not round bit for bit, the old world's
    against the new world's (:func:`_world_digests`), and an int8 commit's
    moments assembled on rank 0's host from both worlds' shards, within
    their tiles' rounding. Appends to ``checks`` each commit's figures
    and, on rank 0, to ``cuts`` its step, the moments an int8 commit
    delivered, its params (assembled) and, for a lossless commit after an
    int8 one, its moments (``seat``: with the params, the whole state a
    control is seated on)."""
    from repro_torch.core.rank_controller import RankController, gather_each

    class Checked(RankController):
        after_int8 = False  # an int8 commit came before (every rank knows)

        def _install(self, named, extras, world):
            t_check = time.perf_counter()
            host0 = self.pool.staging.bytes
            src, quant = self._named(), self.wire_policy is not None
            old_par, new_par = self.world.parallel, world.parallel
            moments = [s for s in self._specs if s.collection in ("mu", "nu")]
            rounded = moments if quant else []
            exact = [s for s in self._specs if s not in rounded]
            old_d = _world_digests(src, old_par, exact, self.rank, dev)
            new_d = _world_digests(named, new_par, exact, self.rank, dev)
            unequal = [s.name for s, a, b in zip(exact, old_d, new_d) if a != b]
            assert not unequal, f"not the cut's bytes: {unequal}"
            worst_q, nu_zeroed = 0.0, [0, 0]
            cut = {"step": self.step, "moments": {}, "params": {}}
            params = [s for s in self._specs if s.collection == "params"]
            for spec, b in gather_each(self.pool, named, new_par, params, "cpu"):
                if b is not None:
                    cut["params"][spec.name] = b
            if self.after_int8 and not quant:
                cut["seat"] = {spec.name: b for spec, b in gather_each(self.pool, named, new_par, moments, "cpu")
                               if b is not None}
            self.after_int8 = self.after_int8 or quant
            src_iter = gather_each(self.pool, src, old_par, rounded, "cpu")
            dst_iter = gather_each(self.pool, named, new_par, rounded, "cpu")
            for (spec, a), (_, b) in zip(src_iter, dst_iter):
                if a is None:
                    continue
                amax, err, nonzero, zeroed = _cut_check(a, b, dev)
                tol = amax / 254 * 1.0001
                worst_q = max(worst_q, err / max(tol, 1e-30))
                assert err <= tol, spec.name
                cut["moments"][spec.name] = b
                if spec.collection == "nu":
                    nu_zeroed[0] += zeroed
                    nu_zeroed[1] += nonzero
                del a, b
            if self.pool.rank == 0:
                cuts.append(cut)
            checks.append({"check_s": time.perf_counter() - t_check, "exact": len(exact), "int8": quant, "quant_worst": worst_q,
                           "card_gb": _card_used_gb(), "host_bytes": self.pool.staging.bytes - host0,
                           "nu_zeroed": nu_zeroed, "step": cut["step"]})
            return super()._install(named, extras, world)

    return Checked


def _rank_train_program(rank: int, pool) -> dict:
    """Phase 42 on one rank process (see the module docstring)."""
    import gc

    import torch.distributed as dist

    from repro_torch.core.rank_controller import gather_each
    from repro_torch.core.resource_view import build_tensor_specs
    from repro_torch.distribution.groups import make_world_groups
    from repro_torch.distribution.step import make_grad_fn, shard_params
    from repro_torch.launch.ranks import rank_device
    from repro_torch.optim import AdamWConfig
    from repro_torch.reshard import WirePolicy
    from repro_torch.utils.pytree import tree_paths

    R_ = RANK_TRAIN
    dev = rank_device(R_["device"], rank)
    opt = AdamWConfig(learning_rate=1e-4, warmup_steps=2, total_steps=1000)
    dp2tp2, dp1tp4 = ParallelConfig(dp=2, tp=2), ParallelConfig(dp=1, tp=4)
    out: dict = {"rank": rank}
    t0 = time.perf_counter()
    refs = _rank_references() if rank == 0 else None
    dist.barrier()
    out["refs_s"] = time.perf_counter() - t0
    pspecs = build_tensor_specs(_rank_cfg(), include_optimizer=False)

    # the first step on the shards against the one-process world's, in f32
    # and in bf16 compute (the bf16 one's launches counted)
    g = make_world_groups(pool, [dp2tp2])[dp2tp2]
    params = M.init_params(_rank_cfg(), torch.Generator(device=dev).manual_seed(0), dev)
    shards = shard_params(_rank_cfg(), params, dp2tp2, rank)
    del params
    tokens = torch.from_numpy(_rank_data().shard_at(0, g.dp_rank, g.dp)).to(dev, torch.long)
    for dtype in ("float32", "bfloat16"):
        _zero_counts()
        loss, _, grads = make_grad_fn(_rank_cfg(dtype), groups=g)(shards, {"tokens": tokens})
        loss = float(loss)
        if dtype == "bfloat16":
            out["bf16_launches"] = _all_counts()
        named = {f"params/{p}": x for p, x in tree_paths(grads).items()}
        whole = {spec.name: w for spec, w in gather_each(pool, named, dp2tp2, pspecs, "cpu") if w is not None}
        del grads, named
        if rank == 0:
            f32_loss, f32 = refs["float32"]
            gap = _grad_gap(whole, f32, dev)
            if dtype == "float32":
                rel = abs(loss - f32_loss) / abs(f32_loss)
                out["first"] = (loss, f32_loss, rel, *gap)
                assert gap[0] <= RANK_GRAD_TOL and rel <= RANK_GRAD_TOL, out["first"]
            else:
                one_loss, one = refs["bfloat16"]
                out["first_bf16"] = dict(loss=loss, one_loss=one_loss, f32_loss=f32_loss, vs_f32=gap,
                                         vs_one=_grad_gap(whole, one, dev), one_vs_f32=refs["bf16_vs_f32"],
                                         order=refs["bf16_order"])
                assert math.isfinite(loss) and gap[0] <= RANK_BF16_FACTOR * refs["bf16_vs_f32"][0], out["first_bf16"]
        del whole
    del shards, refs
    gc.collect()
    torch.cuda.empty_cache()

    checks: list = []
    cuts: list = []  # rank 0: each commit's step, the moments an int8 commit delivered, its params

    Checked = _checked_controller(dev, checks, cuts)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    ctrl = Checked(_rank_cfg(), dp2tp2, opt, R_["seq"], R_["batch"], pool, worlds=[dp1tp4], device=dev,
                   overlap="stream", stream_k=R_["stream_k"], wire_policy=WirePolicy())
    out["mock_s"] = ctrl.world.timings.get("mock_s")
    out["aten_ops"] = ctrl.world.timings.get("aten_ops")
    _zero_counts()
    card = [_card_used_gb()]
    host, peaks = [], []

    def run(n):
        losses = []
        for _ in range(n):
            h0 = (pool.staging.bytes, pool.staging.seconds)
            losses += ctrl.train_steps(1)
            host.append((pool.staging.bytes - h0[0], pool.staging.seconds - h0[1], len(ctrl.records)))
            card.append(_card_used_gb())
            peaks.append(_step_peak_gb(dev))
        return losses

    losses = run(R_["before"])
    ctrl.request_resize(dp1tp4)
    during = 0
    while not ctrl.records:
        losses += run(1)
        during += 1
        assert during < 100, "the streamed resize never committed"
    losses += run(R_["between"])
    ctrl.wire_policy = None  # the way back is lossless
    ctrl.request_resize(dp2tp2, overlap="stop_copy")
    while len(ctrl.records) < 2:
        losses += run(1)
        assert len(losses) < 200, "the stop-copy resize never committed"
    losses += run(R_["after"])
    out["launches"] = _all_counts()
    out["peak_gb"], out["step_peaks"] = max(peaks), peaks
    final = {spec.name: w for spec, w in gather_each(pool, ctrl._named(), ctrl.world.parallel, pspecs, "cpu")
             if w is not None}
    out.update(losses=losses, during=during, checks=checks, host=host,
               card_gb=max(card + [c["card_gb"] for c in checks]),
               step_times=ctrl.iteration_times, records=[dataclasses.asdict(r) for r in ctrl.records],
               commits=[dataclasses.asdict(c) for c in ctrl.rank_commits], world=ctrl.world.parallel.describe())
    del ctrl
    gc.collect()
    torch.cuda.empty_cache()
    if rank == 0:  # the others wait at the barrier, holding no state
        out.update(_rank_controls(opt, len(losses), cuts, final, dev))
    dist.barrier()
    return out


def _step_peak_gb(dev) -> float:
    """The allocator's peak on ``dev`` since the last call (GB); 0 off the
    card."""
    if dev.type != "cuda":
        return 0.0
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    torch.cuda.reset_peak_memory_stats(dev)
    return peak


def _hold_steps(ph: str, r0: dict) -> None:
    """Each commit's destination world by its steps (``_step_gap``), where
    the int8 commit's moments kept the bound. A lossless commit is held
    within RANK_STEP_TOL: against the control where no int8 commit came
    before, else against its own control seated on the run's state at the
    cut. An int8 commit's world is printed beside the witness's, and held
    by the masked parity."""
    steps = sorted(r0["run_steps"])
    assert len(steps) == len(r0["records"]), (steps, r0["records"])
    int8 = any(c["int8"] for c in r0["checks"])
    for step, rec, check in zip(steps, r0["records"], r0["checks"]):
        lossless = not check["int8"]
        seated = r0["seated_steps"].get(step)
        run, wit = r0["run_steps"][step], r0["witness_steps"].get(step)
        text = (f"commit at step {step} into {rec['dst']}: its world's steps, ||(p - p_cut) - (c - c_cut)|| / "
                f"||c - c_cut|| where the bound held, the largest over leaves (a world that skips its update reads "
                f"1): against the control {run[0]:.3e} at {run[1]}"
                + (f", the witness's {wit[0]:.3e} at {wit[1]}" if wit else "")
                + (f"; against a control seated on the run's state at the cut {seated[0]:.3e} at {seated[1]}"
                   if seated else ""))
        held = seated or (run if not int8 else None)
        log(ph, text + (f" (limit {RANK_STEP_TOL:g})" if lossless else " (the int8 commit: not held here)"))
        if lossless:
            assert held is not None and held[0] <= RANK_STEP_TOL, (step, run, seated)


def _peaks_text(r0: dict) -> str:
    """Rank 0's allocator peak a step of the resized run, commits marked."""
    return ", ".join(f"{p:.2f}" + ("*" if h[2] != (r0["host"][i - 1][2] if i else 0) else "")
                     for i, (p, h) in enumerate(zip(r0["step_peaks"], r0["host"])))


def _gap_text(g: dict) -> str:
    return (f"where kept max |diff| {g['kept'][0]:.3e} at {g['kept'][1]}, where broken {g['masked'][0]:.3e} at "
            f"{g['masked'][1]}; {g['past']} entries past 1e-2, {g['past_in_mask']} of them where broken")


def phase_rank_worlds() -> list[dict]:
    """Starts the 4 rank processes once for phases 42 and 43 (see the
    module docstring); each rank's results, logged and held by
    ``phase_rank_train`` and ``phase_rank_pp_ep``."""
    import gc
    import os

    from repro_torch.launch.ranks import run_ranks

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    # the rank processes' allocators map memory in expandable segments:
    # four caches of freed blocks on one card would hold ~10 GB between them
    conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        ranks = run_ranks(_rank_worlds_program, RANK_TRAIN["nproc"], device=RANK_TRAIN["device"], threads=2,
                          timeout=900)
    finally:
        if conf is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = conf
    t = ranks[0]["t"]
    log("rank-worlds", f"{RANK_TRAIN['nproc']} rank processes on one card under gloo, started once for phases 42 and "
                       f"43: {time.perf_counter() - t0:.1f}s in all, {min(r['t'][0] for r in ranks) - t0:.1f}-"
                       f"{max(r['t'][0] for r in ranks) - t0:.1f}s to start them; on rank 0's clock phase 42 "
                       f"{t[1] - t[0]:.1f}s, "
                       + ", ".join(f"{p['name']} {b - a:.1f}s" for p, a, b in zip(_pp_ep_parts(), t[1:], t[2:])))
    gc.collect()
    torch.cuda.empty_cache()
    return ranks


def _rank_worlds_program(rank: int) -> dict:
    """One rank process: phase 42, then phase 43's parts, on one pool."""
    from repro_torch.distribution.groups import RankPool
    from repro_torch.launch.ranks import rank_device

    t = [time.perf_counter()]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pool = RankPool()
    out = {"train": _rank_train_program(rank, pool), "parts": []}
    t.append(time.perf_counter())
    for part in _pp_ep_parts():
        out["parts"].append(_pp_ep_part(pool, rank, rank_device(RANK_PP_EP["device"], rank), part))
        t.append(time.perf_counter())
    return {**out, "t": t}


def phase_rank_train(ranks: list[dict]) -> tuple[dict, dict]:
    """Per-rank training worlds (see the module docstring, 42), from the
    ranks' results (``phase_rank_worlds``). Returns the ranks' summed
    launches on the path: the resized run's, and the bf16 first step's."""
    ranks = [r["train"] for r in ranks]
    r0 = ranks[0]
    cfg = _rank_cfg()
    log("rank-train", f"{cfg.name} full width, {cfg.num_layers} of 28 layers, {RANK_TRAIN['nproc']} rank processes "
                      f"on one card under gloo, batch {RANK_TRAIN['batch']} x {RANK_TRAIN['seq']}; "
                      f"rank 0's references alone {r0['refs_s']:.1f}s")
    loss, want, rel, gap, leaf = r0["first"]
    log("rank-train", f"first step (f32), dp2tp2 ranks against the one-process world: loss {loss:.6f} / {want:.6f} "
                      f"(relative {rel:.3e}), gradients max |g - g_1| / max |g_1| {gap:.3e} at {leaf} (tol "
                      f"{RANK_GRAD_TOL:g})")
    b = r0["first_bf16"]
    log("rank-train", f"first step (bf16 compute): loss per-rank {b['loss']:.6f}, one process {b['one_loss']:.6f}, "
                      f"f32 {b['f32_loss']:.6f}; gradients, max |g - g_ref| / max |g_ref|: per-rank against the "
                      f"one-process bf16 {b['vs_one'][0]:.3e} at {b['vs_one'][1]}; the one-process bf16 against its "
                      f"twin summing the rows in two halves {b['order'][0]:.3e} at {b['order'][1]}; against the f32 "
                      f"step: per-rank {b['vs_f32'][0]:.3e} at {b['vs_f32'][1]}, one-process {b['one_vs_f32'][0]:.3e} "
                      f"at {b['one_vs_f32'][1]} (limit {RANK_BF16_FACTOR:g}x the latter)")
    bf16 = {k: sum(r["bf16_launches"].get(k, 0) for r in ranks) for k in ranks[0]["bf16_launches"]}
    log("rank-train", f"bf16 first step's flash launches summed over the ranks: forward {bf16['flash_attention']} "
                      f"({bf16['flash_attention_tc']} tensor_cores), backward {bf16['flash_attention_bwd']} "
                      f"({bf16['flash_attention_bwd_tc']} tensor_cores)")
    assert bf16["flash_attention_tc"] > 0 and bf16["flash_attention_bwd_tc"] > 0, bf16
    losses = r0["losses"]
    assert all(np.isfinite(losses)), losses
    assert all(r["losses"][: RANK_TRAIN["before"]] == losses[: RANK_TRAIN["before"]] for r in ranks), "ranks disagree"
    log("rank-train", f"losses {[round(x, 4) for x in losses]}; the control's {[round(x, 4) for x in r0['control_losses']]}")
    assert [r["dst"] for r in r0["records"]] == ["dp1xpp1xtp4", "dp2xpp1xtp2"], r0["records"]
    for i, (rec, check) in enumerate(zip(r0["records"], r0["checks"])):
        commit = [r["commits"][i] for r in ranks]
        host_b = sum(c["host_bytes"] - r["checks"][i]["host_bytes"] for c, r in zip(commit, ranks))
        host_s = max(c["host_seconds"] for c in commit)
        check_s = check["check_s"]  # rank 0's, inside its pause
        # the check runs inside the update of a split-step commit, inside the transfer of a stop-copy
        split = rec["mode"] == "live_overlap"
        log("rank-train", f"commit {i + 1} {rec['mode']} {rec['src']} -> {rec['dst']}: pause_s "
                          f"{rec['total_pause_s'] - check_s:.4f} (the check's {check_s:.3f}s taken out), prepare_s "
                          f"{rec['prepare_s']:.4f}, update_s {rec['update_s'] - (check_s if split else 0):.4f}, "
                          f"transfer_s {rec['transfer_s'] - (0 if split else check_s):.4f}; "
                          f"plan {rec['plan_network_bytes'] / 1e9:.4f} GB remote + {rec['plan_local_bytes'] / 1e9:.4f} "
                          f"GB local, wire {rec['wire_bytes'] / 1e9:.4f} GB, logical {rec['logical_bytes'] / 1e9:.4f} "
                          f"GB; host staging {host_b / 1e9:.4f} GB over the ranks (the check's taken out), "
                          f"{host_s:.3f}s of copies at most a rank; "
                          f"dirty layers {rec['dirty_layers']}/{rec['layers_total']}; cut (step {check['step']}) held: "
                          f"{check['exact']} tensors bit for bit, int8 moments at {check['quant_worst']:.3f} of their "
                          f"bound, nu entries the wire rounded to 0: {check['nu_zeroed'][0]} of "
                          f"{check['nu_zeroed'][1]} nonzero")
    plain = [t for i, t in enumerate(r0["step_times"]) if r0["host"][i][2] == (r0["host"][i - 1][2] if i else 0)]
    step_host = [h for i, h in enumerate(r0["host"]) if h[2] == (r0["host"][i - 1][2] if i else 0)]
    log("rank-train", f"step_s (host clock, steps without a commit, pre-copy rounds included): per-rank median "
                      f"{statistics.median(plain):.4f} over {len(plain)} steps, first {r0['step_times'][0]:.4f}; "
                      f"one-process dp2tp2 control median {r0['control_step_s']:.4f}; host staging a step on rank 0 "
                      f"median {statistics.median(h[0] for h in step_host) / 1e9:.4f} GB in "
                      f"{statistics.median(h[1] for h in step_host):.4f}s")
    log("rank-train", f"mock warm-up of rank 0's dp2tp2 step on meta {r0['mock_s']:.3f}s ({r0['aten_ops']} aten ops) "
                      f"against its first real step {r0['step_times'][0]:.3f}s")
    log("rank-train", "peak memory per rank " + ", ".join(f"{r['peak_gb']:.2f}" for r in ranks)
        + f" GB (torch allocator); card in use at most {max(r['card_gb'] for r in ranks):.2f} GB (sampled); rank 0's "
          f"peak a step (GB, * a commit's) {_peaks_text(r0)}")
    log("rank-train", f"{r0['masked_entries']} param entries where the int8 commit's moments broke |mu| <= sqrt(nu) "
                      f"(\"broken\"); the witness runs from the control's state at that commit with the rows summed "
                      f"in two halves")
    for step, run in r0["run_at_cut"].items():
        wit = r0["witness_at_cut"].get(step)
        limit = max(RANK_PARITY_TOL, RANK_MASKED_FACTOR * wit["masked"][0]) if wit else RANK_PARITY_TOL
        log("rank-train", f"the cut at step {step} against the control: {_gap_text(run)}"
            + (f"; the witness against the control: {_gap_text(wit)}" if wit else "")
            + f" (limits {RANK_PARITY_TOL:g} kept, {limit:.3e} broken)")
        assert run["kept"][0] < RANK_PARITY_TOL and run["masked"][0] <= limit, (step, run, wit)
    run, wit = r0["run_final"], r0["witness_final"]
    limit = max(RANK_PARITY_TOL, RANK_MASKED_FACTOR * wit["masked"][0])
    log("rank-train", f"final params against the control never resized: {_gap_text(run)}; the witness against the "
                      f"control: {_gap_text(wit)} (limits {RANK_PARITY_TOL:g} kept, RESHAPE_PARITY_TOL, and "
                      f"{limit:.3e} broken, {RANK_MASKED_FACTOR:g}x the witness); steps during the streamed resize "
                      f"{r0['during']}")
    assert run["kept"][0] < RANK_PARITY_TOL, f"resized params diverge from the control: {run}"
    assert run["masked"][0] <= limit, f"resized params part from the control past the witness: {run}, {wit}"
    _hold_steps("rank-train", r0)
    launches = {k: sum(r["launches"].get(k, 0) for r in ranks) for k in ranks[0]["launches"]}
    for name in RANK_KERNELS:
        assert launches[name] > 0, f"{name} was not launched on the per-rank path"
    log("rank-train", "launches of the resized run summed over the ranks: "
        + ", ".join(f"{k} {launches[k]}" for k in RANK_KERNELS))
    return launches, bf16


# phase 43: per-rank pipeline- and expert-parallel worlds on the one card
# (see the module docstring)
# qwen3 at 4 of 28 layers and one step before, between and after the
# commits, for the script's time; two layers a pre-copy round, so that
# qwen3's 5 layers (4 blocks and the embedding's) stream over 3 rounds
# with training steps between them and its commit re-syncs the dirty ones
# (mixtral's 2 go in one)
RANK_PP_EP = dict(nproc=4, qwen3_layers=4, before=1, between=1, after=1, stream_k=2, device="cuda")
# the JAX package's MoE cut for training on one card (phase 35's)
MIXTRAL_RANK_LAYERS = MIXTRAL_TRAIN_LAYERS
PP_EP_KERNELS = {"qwen3": RANK_KERNELS,
                 # both mixtral commits are lossless: no quant kernel on its path
                 "mixtral": ("flash_attention", "flash_attention_bwd", "pack_rows", "scatter_rows")}


def _pp_ep_parts() -> list[dict]:
    """The phase's two parts: each config (f32 compute, as phase 42's
    resized run), its first world, the two resizes, the microbatches, the
    streamed commit's wire, and the one-process control's world and its
    witness's (see ``_rank_controls``)."""
    P = ParallelConfig
    return [
        dict(name="qwen3", cfg=dataclasses.replace(_rank_cfg(), num_layers=RANK_PP_EP["qwen3_layers"]),
             src=P(pp=2, tp=2), first=P(dp=2, tp=2), second=P(pp=2, tp=2),
             microbatches=4, int8=True, control=dict(par=P(pp=2, tp=2), microbatches=4, twin_par=P(dp=2, tp=2))),
        # the split-step commit holds both worlds' state and gradients: into
        # tp4 (20.6 GB of params and moments over the ranks) it fits the
        # card; into ep4 (31.5 GB: the embedding and head whole on every
        # rank) it ran out of memory, so ep4 is the stop-copy's target
        dict(name="mixtral", cfg=dataclasses.replace(moe_cut(MIXTRAL, MIXTRAL_RANK_LAYERS), dtype="float32"),
             src=P(ep=2, tp=2), first=P(tp=4), second=P(ep=4), microbatches=1, int8=False,
             control=dict(par=P(ep=2, tp=2), microbatches=1)),
    ]


class _RouteKeeps:
    """Records the keep mask of every ``moe.route`` call while entered (the
    one-process ``routing`` and the per-rank ``moe_apply_rank`` both route
    through it)."""

    def __enter__(self):
        from repro_torch.models import moe as moe_mod

        self.mod, self.orig, self.keeps = moe_mod, moe_mod.route, []

        def recorded(probs, cfg):
            out = self.orig(probs, cfg)
            self.keeps.append(out[3])
            return out

        moe_mod.route = recorded
        return self

    def __exit__(self, *exc):
        self.mod.route = self.orig


def _pp_ep_part(pool, rank: int, dev, part: dict) -> dict:
    """One part of phase 43 on one rank process (see the module
    docstring)."""
    import gc

    import torch.distributed as dist

    from repro_torch.core.rank_controller import gather_each
    from repro_torch.core.resource_view import build_tensor_specs
    from repro_torch.core.shadow import rank_step_fns
    from repro_torch.data import SyntheticLM
    from repro_torch.distribution.groups import make_world_groups
    from repro_torch.distribution.pipeline import make_pipeline_grad_fn
    from repro_torch.distribution.step import make_grad_fn, shard_params
    from repro_torch.optim import AdamWConfig
    from repro_torch.reshard import WirePolicy
    from repro_torch.utils.pytree import tree_paths

    R_, cfg, src, mb = RANK_PP_EP, part["cfg"], part["src"], part["microbatches"]
    opt = AdamWConfig(learning_rate=1e-4, warmup_steps=2, total_steps=1000)
    data = SyntheticLM(cfg.vocab_size, RANK_TRAIN["seq"], RANK_TRAIN["batch"], 0)
    pspecs = build_tensor_specs(cfg, include_optimizer=False)
    out: dict = {}

    # rank 0 alone: the one-process world's first step, and its routing
    t0 = time.perf_counter()
    refs = None
    if rank == 0:
        params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
        batch = {"tokens": torch.from_numpy(data.global_batch_at(0)).to(dev, torch.long)}
        grad_fn = make_pipeline_grad_fn(cfg, src, mb) if src.pp > 1 else make_grad_fn(cfg, mb)
        with _RouteKeeps() as routed:
            loss, _, grads = grad_fn(params, batch)
        refs = (float(loss), {f"params/{p}": g.cpu() for p, g in tree_paths(grads).items()}, routed.keeps)
        del params, grads
        torch.cuda.empty_cache()
    dist.barrier()
    out["refs_s"] = time.perf_counter() - t0

    # the first step on the shards
    g = make_world_groups(pool, [src])[src]
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    shards = shard_params(cfg, params, src, rank)
    del params
    tokens = torch.from_numpy(data.shard_at(0, g.dp_rank, g.dp)).to(dev, torch.long)
    t0 = time.perf_counter()
    with _RouteKeeps() as routed:
        loss, _, grads = rank_step_fns(cfg, src, opt, mb, g)[1](shards, {"tokens": tokens})
        loss = float(loss)
    out["first_s"] = time.perf_counter() - t0
    t_first = t0
    out["keeps"] = [(int(k.sum()), k.numel()) for k in routed.keeps]
    named = {f"params/{p}": x for p, x in tree_paths(grads).items()}
    whole = {spec.name: w for spec, w in gather_each(pool, named, src, pspecs, "cpu") if w is not None}
    if rank == 0:
        one_loss, one, one_keeps = refs
        gap = _grad_gap(whole, one, dev)
        rel = abs(loss - one_loss) / abs(one_loss)
        same = len(one_keeps) == len(routed.keeps) and all(
            torch.equal(a, b) for a, b in zip(one_keeps, routed.keeps))
        out["first"] = (loss, one_loss, rel, *gap, same)
        assert gap[0] <= RANK_GRAD_TOL and rel <= RANK_GRAD_TOL and same, out["first"]
    del shards, grads, named, whole, refs, routed
    gc.collect()
    torch.cuda.empty_cache()

    # the resized run
    t_run = time.perf_counter()
    out["first_check_s"] = t_run - t_first
    checks, cuts, card, host, peaks = [], [], [], [], []
    Checked = _checked_controller(dev, checks, cuts)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    ctrl = Checked(cfg, src, opt, RANK_TRAIN["seq"], RANK_TRAIN["batch"], pool, worlds=[part["first"], part["second"]],
                   device=dev, microbatches=mb, overlap="stream", stream_k=R_["stream_k"],
                   wire_policy=WirePolicy() if part["int8"] else None)
    out["mock_s"] = ctrl.world.timings.get("mock_s")
    out["aten_ops"] = ctrl.world.timings.get("aten_ops")
    _zero_counts()  # the path's counts start here ...
    card.append(_card_used_gb())

    def run(n):
        losses = []
        for _ in range(n):
            h0 = (pool.staging.bytes, pool.staging.seconds)
            losses += ctrl.train_steps(1)
            host.append((pool.staging.bytes - h0[0], pool.staging.seconds - h0[1], len(ctrl.records)))
            card.append(_card_used_gb())
            peaks.append(_step_peak_gb(dev))
        return losses

    losses = run(R_["before"])
    ctrl.request_resize(part["first"])
    while not ctrl.records:
        losses += run(1)
        assert len(losses) < 100, "the streamed resize never committed"
    losses += run(R_["between"])
    ctrl.wire_policy = None  # the second commit is lossless
    ctrl.request_resize(part["second"], overlap="stop_copy")
    while len(ctrl.records) < 2:
        losses += run(1)
        assert len(losses) < 200, "the stop-copy resize never committed"
    losses += run(R_["after"])
    out["launches"] = _all_counts()  # ... and are read here
    out["peak_gb"], out["step_peaks"] = max(peaks), peaks
    final = {spec.name: w for spec, w in gather_each(pool, ctrl._named(), ctrl.world.parallel, pspecs, "cpu")
             if w is not None}
    out.update(losses=losses, checks=checks, host=host, card_gb=max(card + [c["card_gb"] for c in checks]),
               step_times=ctrl.iteration_times, records=[dataclasses.asdict(r) for r in ctrl.records],
               commits=[dataclasses.asdict(c) for c in ctrl.rank_commits], world=ctrl.world.parallel)
    del ctrl
    gc.collect()
    torch.cuda.empty_cache()
    t_controls = time.perf_counter()
    out["run_s"] = t_controls - t_run
    if rank == 0:  # the others wait at the barrier, holding no state
        out.update(_rank_controls(opt, len(losses), cuts, final, dev, cfg=cfg, **part["control"]))
    del final
    dist.barrier()
    out["controls_s"] = time.perf_counter() - t_controls
    return out


def _steps_by_world(r: dict) -> dict:
    """A rank's step times of the steps in which no commit landed, by the
    world they ran on (0 the first, then one more each commit)."""
    out: dict = {}
    for i, t in enumerate(r["step_times"]):
        world = r["host"][i][2]
        if world == (r["host"][i - 1][2] if i else 0):
            out.setdefault(world, []).append(t)
    return out


def phase_rank_pp_ep(ranks: list[dict]) -> dict:
    """Per-rank pipeline- and expert-parallel worlds (see the module
    docstring, 43), from the ranks' results (``phase_rank_worlds``).
    Returns the ranks' summed launches on the two parts' paths."""
    launches: dict = {}
    for index, part in enumerate(_pp_ep_parts()):
        rs = [r["parts"][index] for r in ranks]
        name, cfg = part["name"], part["cfg"]
        r0 = rs[0]
        ph = f"rank-{name}"
        log(ph, f"where rank 0's {ranks[0]['t'][index + 2] - ranks[0]['t'][index + 1]:.1f}s went (its host clock): "
                f"one-process first step {r0['refs_s']:.1f}s, the ranks' first step with its check "
                f"{r0['first_check_s']:.1f}s, the resized run {r0['run_s']:.1f}s (of it the cut checks "
                f"{sum(c['check_s'] for c in r0['checks']):.1f}s), the one-process control {r0['controls_s']:.1f}s")
        log(ph, f"{cfg.name} full width, {cfg.num_layers} layers, f32 compute, batch {RANK_TRAIN['batch']} x "
                f"{RANK_TRAIN['seq']}, {part['microbatches']} microbatches, {RANK_PP_EP['nproc']} rank processes on "
                f"one card under gloo: {_short(part['src'])} -> {_short(part['first'])} (stream, stream_k "
                f"{RANK_PP_EP['stream_k']}, {'int8 moments' if part['int8'] else 'lossless'}) -> "
                f"{_short(part['second'])} (stop-copy, lossless)")
        loss, want, rel, gap, leaf, same = r0["first"]
        log(ph, f"first step (f32) of the {_short(part['src'])} ranks against the one-process world: loss {loss:.6f} "
                f"/ {want:.6f} (relative {rel:.3e}), gradients max |g - g_1| / max |g_1| {gap:.3e} at {leaf} (tol "
                f"{RANK_GRAD_TOL:g}); route calls {len(r0['keeps'])}, kept pairs {[k for k, _ in r0['keeps']]} of "
                f"{[n for _, n in r0['keeps']]}, every pair kept or dropped as one process: {same}")
        assert all(r["keeps"] == r0["keeps"] for r in rs), "the ranks route different pairs"
        losses = r0["losses"]
        assert all(np.isfinite(losses)), losses
        assert all(r["losses"][:RANK_PP_EP["before"]] == losses[:RANK_PP_EP["before"]] for r in rs), "ranks disagree"
        control = r0["control_losses"]
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, control))
        log(ph, f"losses {[round(x, 4) for x in losses]}; the one-process control's "
                f"{[round(x, 4) for x in control]} (largest relative gap {loss_gap:.3e})")
        assert loss_gap < RANK_PARITY_TOL, (losses, control)
        assert [r["dst"] for r in r0["records"]] == [part["first"].describe(), part["second"].describe()]
        for i, (rec, check) in enumerate(zip(r0["records"], r0["checks"])):
            commit = [r["commits"][i] for r in rs]
            host_b = sum(c["host_bytes"] - r["checks"][i]["host_bytes"] for c, r in zip(commit, rs))
            pairs = {(k, int(d)): n for k, c in enumerate(commit) for d, n in c["sent_bytes"].items()}
            check_s = check["check_s"]
            split = rec["mode"] == "live_overlap"
            log(ph, f"commit {i + 1} {rec['mode']} {rec['src']} -> {rec['dst']}: pause_s "
                    f"{rec['total_pause_s'] - check_s:.4f} (the check's {check_s:.3f}s taken out), prepare_s "
                    f"{rec['prepare_s']:.4f}; plan {rec['plan_network_bytes'] / 1e9:.4f} GB remote + "
                    f"{rec['plan_local_bytes'] / 1e9:.4f} GB local, wire {rec['wire_bytes'] / 1e9:.4f} GB, logical "
                    f"{rec['logical_bytes'] / 1e9:.4f} GB; host staging {host_b / 1e9:.4f} GB over the ranks (the "
                    f"check's taken out), {max(c['host_seconds'] for c in commit):.3f}s of copies at most a rank; "
                    f"dirty layers {rec['dirty_layers']}/{rec['layers_total']}; bytes sent by rank pair (GB) "
                    + ", ".join(f"{a}->{b} {n / 1e9:.4f}" for (a, b), n in sorted(pairs.items()))
                    + f"; cut (step {check['step']}) held: {check['exact']} tensors bit for bit, int8 moments at "
                      f"{check['quant_worst']:.3f} of their bound{' (update_s included in the pause)' if split else ''}")
            assert rec["generic_cells"] == 0 and rec["executed_bytes"] > 0, rec
        streamed = r0["records"][0]
        # qwen3's streamed commit copies over several rounds with steps
        # between them: the layers copied before the commit are re-synced
        assert streamed["dirty_layers"] > 0 or streamed["layers_total"] <= RANK_PP_EP["stream_k"], streamed
        worlds = (part["src"], part["first"], part["second"])
        by_world = [_steps_by_world(r) for r in rs]
        step_host = [h for i, h in enumerate(r0["host"]) if h[2] == (r0["host"][i - 1][2] if i else 0)]
        log(ph, "step_s (host clock, steps without a commit, pre-copy rounds included) median per rank: "
                + "; ".join(f"on {_short(worlds[w])} " + ", ".join(f"{statistics.median(b[w]):.4f}" for b in by_world)
                            for w in sorted(by_world[0]))
                + f"; one-process {_short(part['control']['par'])} control median {r0['control_step_s']:.4f}; "
                  f"host staging a step on rank 0 median {statistics.median(h[0] for h in step_host) / 1e9:.4f} "
                  f"GB in {statistics.median(h[1] for h in step_host):.4f}s")
        log(ph, f"mock warm-up of rank 0's {_short(part['src'])} step on meta {r0['mock_s']:.3f}s ({r0['aten_ops']} "
                f"aten ops) against its first real step {r0['first_s']:.3f}s")
        log(ph, "peak memory per rank " + ", ".join(f"{r['peak_gb']:.2f}" for r in rs)
            + f" GB (torch allocator); card in use at most {max(r['card_gb'] for r in rs):.2f} GB (sampled); rank "
              f"0's peak a step (GB, * a commit's) {_peaks_text(r0)}")
        for step, run in r0["run_at_cut"].items():
            wit = r0["witness_at_cut"].get(step)
            limit = max(RANK_PARITY_TOL, RANK_MASKED_FACTOR * wit["masked"][0]) if wit else RANK_PARITY_TOL
            log(ph, f"the cut at step {step} against the control: {_gap_text(run)}"
                + (f"; the witness against the control: {_gap_text(wit)}" if wit else "")
                + f" (limits {RANK_PARITY_TOL:g} kept, {limit:.3e} broken)")
            assert run["kept"][0] < RANK_PARITY_TOL and run["masked"][0] <= limit, (step, run, wit)
        run, wit = r0["run_final"], r0.get("witness_final")
        limit = max(RANK_PARITY_TOL, RANK_MASKED_FACTOR * wit["masked"][0]) if wit else RANK_PARITY_TOL
        log(ph, f"final params against the control never resized: {_gap_text(run)}"
            + (f"; the witness against the control: {_gap_text(wit)}" if wit else "")
            + f" (limits {RANK_PARITY_TOL:g} kept, {limit:.3e} broken; {r0['masked_entries']} entries broken)")
        assert run["kept"][0] < RANK_PARITY_TOL and run["masked"][0] <= limit, (run, wit)
        _hold_steps(ph, r0)
        counts = {k: sum(r["launches"].get(k, 0) for r in rs) for k in rs[0]["launches"]}
        for k in PP_EP_KERNELS[name]:
            assert counts[k] > 0, f"{k} was not launched on the {name} path"
        log(ph, "launches summed over the ranks: " + ", ".join(f"{k} {counts[k]}" for k in RANK_KERNELS))
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
    return launches


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
    # the per-rank worlds first, while the card holds the least of this
    # process (see the module docstring, 42)
    ranks = phase_rank_worlds()
    rank_train_launches, rank_bf16_launches = phase_rank_train(ranks)
    rank_pp_ep_launches = phase_rank_pp_ep(ranks)
    del ranks
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
    train_ef_launches = phase_train_int8_ef()  # no trace; see the module docstring, 39
    phase_dryrun_card()  # see the module docstring, 40
    lifecycle_launches = phase_lifecycle(train_peak_gb)
    recovery_launches = phase_recovery(train_peak_gb)
    bwd = phase_bwd_times(train_launches["flash_attention_bwd"], bwd_err)
    quants = phase_quant_times(train_launches)
    ssd_err = phase_ssd_cases()
    rms_err = phase_rms_cases()
    phase_small_agreement(dataclasses.replace(get_config("mamba2-2.7b").reduced(), d_ff=0), prompt_len=100)
    ssm_launches, ssm_err = phase_serve_ssm()
    ssm_elastic_launches = phase_elastic("mamba2-2.7b")
    ssd = phase_ssd_times(ssm_launches, max(ssd_err, ssm_err))
    rms = phase_rms_times(rms_err)
    ssd_bwd_err = phase_ssd_bwd_cases()
    # the timing phase before the training phases: the profiler loses more
    # of a trace the later it comes in a run (see the module docstring, 23)
    ssd_bwd = phase_ssd_bwd_times(0, ssd_bwd_err)
    issued = ssd_bwd_tensor_core_flops(SSD_TRAIN_SHAPE, torch.bfloat16)
    log("times", f"ssd_intra_chunk_bwd issues {issued / 1e9:.2f} GFLOP of TF32 products, "
                 f"{issued / ssd_bwd['device_ms'] / 1e9:.2f} TFLOP/s on the tensor cores, for "
                 f"{ssd_bwd_flops(SSD_TRAIN_SHAPE) / 1e9:.2f} GFLOP of least f32 work")
    train_ssm_launches, _ = phase_train_mamba2()
    elastic_train_ssm_launches = phase_elastic_train_mamba2()
    phase_calibrate()
    phase_small_agreement(get_config(SEAMLESS).reduced(), prompt_len=96, frames_len=64)
    seamless_launches, seamless_err = phase_serve_encdec()
    record["max_abs_err"] = record["max_err"] = max(record["max_abs_err"], seamless_err)
    elastic_seamless_launches = phase_elastic(SEAMLESS)
    train_seamless_launches = phase_train_encdec()
    phase_small_agreement(get_config(MIXTRAL).reduced(), prompt_len=128)  # two windows of 64
    serve_mixtral_launches, chunked_mixtral_launches = phase_serve_moe(MIXTRAL)
    elastic_mixtral_launches = phase_elastic_mixtral()
    train_mixtral_launches = phase_train_mixtral()
    serve_jamba_launches, _ = phase_serve_moe(JAMBA)
    serve_llama4_launches, _ = phase_serve_moe(LLAMA4)
    schedule_launches = phase_schedule(train_peak_gb)  # see the module docstring, 23
    # the phases after it take no profiler trace
    chunked_qwen3_launches = phase_chunked_prefill("qwen3-1.7b")
    chunked_mamba2_launches = phase_chunked_prefill("mamba2-2.7b")
    train_pp_launches = phase_train_pipeline()
    phase_examples()  # see the module docstring, 41
    # each record's launches: its counts on the main paths, each counted
    # from zero just before its run and read just after. No path runs
    # rmsnorm: as in the JAX package, the model's norms are plain and only
    # ops.rmsnorm reaches the kernel (phases 18 and 22)
    paths = {"serve": {"flash_attention": launches}, "elastic": elastic_launches, "train": train_launches,
             "lifecycle": lifecycle_launches, "recovery": recovery_launches, "schedule": schedule_launches,
             "serve_mamba2": {"ssd_intra_chunk": ssm_launches}, "elastic_mamba2": ssm_elastic_launches,
             "train_mamba2": train_ssm_launches, "elastic_train_mamba2": elastic_train_ssm_launches,
             "serve_seamless": {"flash_attention": seamless_launches}, "elastic_seamless": elastic_seamless_launches,
             "train_seamless": train_seamless_launches, "serve_mixtral": serve_mixtral_launches,
             "elastic_mixtral": elastic_mixtral_launches, "train_mixtral": train_mixtral_launches,
             "serve_jamba": serve_jamba_launches, "serve_llama4": serve_llama4_launches,
             "chunked_qwen3": chunked_qwen3_launches,
             "chunked_mamba2": chunked_mamba2_launches, "chunked_mixtral": chunked_mixtral_launches,
             "train_pipeline": train_pp_launches, "train_int8_ef": train_ef_launches,
             "rank_train": rank_train_launches, "rank_train_bf16": rank_bf16_launches,
             "rank_pp_ep": rank_pp_ep_launches}
    records = [record, *rows, bwd, *quants, ssd, rms, ssd_bwd]
    for rec in records:
        rec["launches_by_path"] = {p: counts.get(rec["name"], 0) for p, counts in paths.items()}
        rec["launches"] = sum(rec["launches_by_path"].values())
        assert rec["launches"] > 0 or rec["name"] in ("unpack_rows", "rmsnorm"), rec
    assert [r["name"] for r in records] == [
        "flash_attention", "pack_rows", "scatter_rows", "relayout_rows", "unpack_rows", "flash_attention_bwd",
        "pack_quant_rows", "dequant_scatter_rows", "ssd_intra_chunk", "rmsnorm", "ssd_intra_chunk_bwd"]
    log("profile", f"device times from {TRACES['taken']} traces, of which {TRACES['not whole']} were not "
                   f"whole and {TRACES['lost']} held no device event; {TRACES['used not whole']} measurements "
                   f"used a trace that was not whole, {TRACES['events instead']} CUDA events instead")
    ends = [("start", t0), *sorted(PHASE_ENDS.items(), key=lambda kv: kv[1])]
    log("done", "seconds from the last line of one phase tag to the next's (tags that print in several phases "
                "take the last): " + ", ".join(f"{tag} {t1 - t:.1f}" for (_, t), (tag, t1) in zip(ends, ends[1:])))
    log("done", f"{time.perf_counter() - t0:.1f}s")
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
