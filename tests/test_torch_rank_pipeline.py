"""Per-rank worlds with pipeline stages (``distribution/pipeline.py``'s
stage ranks over ``distribution/groups.py``), in one gloo world of 8 CPU
rank processes.

Reduced qwen3-1.7b (4 layers, f32, TF32 off), weights from the JAX
package through ``models.convert.params_from_jax``, a batch of 8 x 32
tokens from a numpy seed, 4 microbatches:

- on pp2tp2, dp2pp2tp2 and pp4tp2 every stage rank computes its loss and
  gradients on its shards and dp rows; the loss of every rank and the
  gradients assembled from the shards are held against
  ``jax.value_and_grad`` of the JAX ``make_pipeline_loss`` (pp2 on 2 host
  devices; the function does not depend on the stage count) and against
  the port's one-process pp2 world, to ``tests/test_torch_pipeline.py``'s
  limits; the clip's norm, summed over pp and tp, against one process's;
- the mock process groups: a stage rank's train step run on meta records,
  op for op with their bytes, the sends, receives and collectives the real
  world's rank counted;
- the JAX package's transition (``tests/test_system.py``) dp2pp2tp2 ->
  dp1pp4tp2 through ``RankExecutor``: every destination shard and the
  engine's counters equal the JAX byte oracle's (``repro/core/
  streaming.py``), and each rank pair sends the JAX plan's bytes;
- ``RankController`` on dp2pp2tp2, streamed (split-step commit) to
  dp1pp4tp2 and back by stop-copy, lossless: each commit's cut (the old
  world's state and the new world's, assembled) bit for bit, the stop-copy
  pairs the JAX plan's bytes, and losses and params bitwise those of a
  control that takes the same worlds at the same steps and carries the
  state by plain tensor copies; losses within 1e-5 and params within
  ``RESHAPE_PARITY_TOL`` of a one-process run never resized;
- pp2tp2 streamed to dp2tp2 with the moments on the int8 wire: the two dp
  replicas of every shard hold the same bytes after the commit and after
  a step on it (a replica's copy that did not cross the wire takes its
  rounding too).

The ranks run port code only; the JAX package is imported by the test
process."""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

from conftest import run_with_devices
from repro_torch.configs import get_config
from repro_torch.configs.base import ParallelConfig as P
from repro_torch.core.resource_view import assemble, build_tensor_specs, view_of
from repro_torch.launch.ranks import run_ranks
from repro_torch.optim import AdamWConfig
from repro_torch.utils.pytree import tree_from_paths, tree_paths

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_num_threads(2)

ARCH = "qwen3-1.7b"
MB, BATCH, SEQ = 4, 8, 32
STEP_WORLDS = [P(pp=2, tp=2), P(dp=2, pp=2, tp=2), P(pp=4, tp=2)]
IDS = ["pp2tp2", "dp2pp2tp2", "pp4tp2"]
SRC, DST = P(dp=2, pp=2, tp=2), P(pp=4, tp=2)
LOSS_TOL = 1e-6  # tests/test_torch_pipeline.py's
GRAD_TOL = 1e-5
NORM_TOL = 1e-6
OPT = AdamWConfig(learning_rate=1e-3, warmup_steps=2)
RUN = dict(before=2, between=2, after=2, stream_k=1)
STAGING = 1 << 20

JAX_SIDE = """
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.configs.base import ParallelConfig
from repro.distribution.pipeline import make_pipeline_loss
from repro.distribution.sharding import make_elastic_mesh
from repro.models import model as M
from repro.utils.pytree import tree_paths

out, arch, pipe = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
cfg = dataclasses.replace(get_config(arch).reduced(), **pipe["replace"])
parallel = ParallelConfig(pp=2)
params = jax.jit(M.init_params, static_argnums=0)(cfg, jax.random.key(0))
toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (pipe["batch"], pipe["seq"])).astype(np.int32)
loss_fn = make_pipeline_loss(cfg, parallel, pipe["microbatches"], make_elastic_mesh(parallel))
loss, grads = jax.jit(jax.value_and_grad(lambda p: loss_fn(p, jnp.asarray(toks))))(params)
flat = {"loss": np.asarray(loss), "tokens": toks}
flat.update({"param/" + p: np.asarray(x) for p, x in tree_paths(params).items()})
flat.update({"grad/" + p: np.asarray(x) for p, x in tree_paths(grads).items()})
np.savez(out, **flat)
"""


def jax_pipeline(tmp_path, arch: str, **replace) -> dict:
    """The JAX pipeline's (pp2) loss and gradients of reduced ``arch`` (its
    fields ``replace``d), with its weights and tokens: one subprocess with
    2 host devices."""
    out = str(tmp_path / f"{arch}.npz")
    arg = json.dumps({"microbatches": MB, "batch": BATCH, "seq": SEQ, "replace": replace})
    run_with_devices(f"import sys; sys.argv = ['-', {out!r}, {arch!r}, {arg!r}]\n" + JAX_SIDE, n_devices=2,
                     timeout=600)
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def _cfg():
    return get_config(ARCH).reduced()


# ---------------------------------------------------------------------------
# Rank-side helpers (shared with tests/test_torch_rank_moe.py)
# ---------------------------------------------------------------------------


def rank_steps(cfg, worlds, groups, rank: int, flat: dict, tokens: np.ndarray, opt, microbatches: int = MB,
               probe=None) -> dict:
    """Each world of ``worlds`` this rank belongs to, from the weights
    ``flat``: its first step's loss, metrics and gradient shards, what
    ``probe()`` returns after it (called before it too), the clip's norm of
    the gradients, and the collectives one train step records; keyed by
    the world's index."""
    from repro_torch.core.shadow import rank_step_fns
    from repro_torch.distribution.step import init_opt_state, shard_params, split_paths
    from repro_torch.models.convert import params_from_jax
    from repro_torch.optim.adamw import global_norm

    out = {}
    for i, world in enumerate(worlds):
        g = groups[world]
        if not g.member:
            continue
        params = shard_params(cfg, params_from_jax(flat, cfg, "cpu"), world, rank)
        b = tokens.shape[0] // world.dp
        batch = {"tokens": torch.from_numpy(tokens[g.dp_rank * b:(g.dp_rank + 1) * b]).long()}
        step_fn, grad_fn, _ = rank_step_fns(cfg, world, opt, microbatches, g)
        if probe:
            probe()
        loss, metrics, grads = grad_fn(params, batch)
        probed = probe() if probe else None
        norm = global_norm(grads, g, split_paths(cfg, world))
        g.collectives.clear()
        step_fn(params, init_opt_state(params), batch)
        out[i] = {"loss": float(loss), "metrics": {k: float(v) for k, v in metrics.items()},
                  "grads": tree_paths(grads), "norm": float(norm), "collectives": list(g.collectives),
                  "probe": probed}
    return out


def oracle_case(rank: int, pool, specs, ca, cb, state: dict) -> dict:
    """This rank's part of one plan from ``ca`` to ``cb`` over the whole
    ``state`` (numpy by name), lossless: its destination shards, bytes
    sent by destination rank, and the engine's stats."""
    from repro_torch.core import streaming as S
    from repro_torch.core.intersection import plan_transfer
    from repro_torch.core.reshard import rank_reshard_planned

    plan = plan_transfer(specs, ca, cb)
    shards = {}
    if rank < ca.world_size:
        shards = {k: torch.from_numpy(v) for k, v in S.materialize_rank(specs, ca, rank, state).shards.items()}
    moved, stats, ex = rank_reshard_planned(specs, plan, shards, rank, pool, "cpu", staging_bytes=STAGING)
    return {"shards": {k: v.clone() for k, v in moved.items()}, "sent": ex.sent_bytes,
            "stats": dataclasses.asdict(stats)}


def _by_hand(pool, rank: int, specs, named: dict, a, b) -> dict:
    """``named`` (this rank's shards on ``a`` by tensor name) on ``b``:
    every tensor assembled on rank 0, broadcast, and cut by ``shard_of``.
    Plain tensor copies, no plan."""
    import torch.distributed as dist

    from repro_torch.core.rank_controller import gather_each
    from repro_torch.core.resource_view import shard_of

    out = {}
    for spec, whole in gather_each(pool, named, a, specs, "cpu"):
        if whole is None:
            whole = torch.empty(spec.shape, dtype=getattr(torch, spec.dtype))
        dist.broadcast(whole, 0)
        if rank < b.world_size:
            shard = shard_of(whole, spec, b, rank)
            if shard is not None:
                out[spec.name] = shard
    return out


def _trees(named: dict) -> tuple[dict, dict]:
    paths = [n[len("params/"):] for n in named if n.startswith("params/")]
    opt = {c: tree_from_paths({p: named[f"{c}/{p}"] for p in paths}) for c in ("mu", "nu")}
    return tree_from_paths({p: named[f"params/{p}"] for p in paths}), opt


def resize_run(rank: int, pool, groups, cfg, ca, cb, run: dict, global_batch: int, seq: int, microbatches: int,
               opt_cfg) -> dict:
    """``RankController`` on ``ca``, streamed (split-step commit) to ``cb``
    after ``run["before"]`` steps, back by stop-copy after
    ``run["between"]`` more, then ``run["after"]`` steps; lossless. Each
    commit's cut is checked on rank 0 (the old world's state against the
    new world's, assembled, bit for bit). Then the control: the same
    worlds' steps at the same steps, the state carried by plain copies
    (:func:`_by_hand`). Returns the run's and the control's losses and
    params (on rank 0), the records and the per-rank commits."""
    from repro_torch.core.rank_controller import RankController, gather_each
    from repro_torch.core.reshard import named_state_leaves
    from repro_torch.core.shadow import rank_step_fns
    from repro_torch.data import SyntheticLM
    from repro_torch.distribution.step import init_opt_state, shard_params
    from repro_torch.models import model as M

    specs = build_tensor_specs(cfg, include_optimizer=True, zero_sharding=False)
    cuts = []

    class Checked(RankController):
        def _install(self, moved, extras, world):
            exact = total = 0
            for (spec, a), (_, b) in zip(gather_each(self.pool, self._named(), self.world.parallel, specs, "cpu"),
                                         gather_each(self.pool, moved, world.parallel, specs, "cpu")):
                if a is not None:
                    total += 1
                    exact += int(torch.equal(a, b))
            cuts.append({"step": self.step, "exact": exact, "total": total})
            return super()._install(moved, extras, world)

    ctrl = Checked(cfg, ca, opt_cfg, seq, global_batch, pool, worlds=[cb], device="cpu", microbatches=microbatches,
                   stream_k=run["stream_k"])
    losses = ctrl.train_steps(run["before"])
    ctrl.request_resize(cb, overlap="stream")
    while not ctrl.records:
        losses += ctrl.train_steps(1)
        assert len(losses) < 200, "the streamed resize never committed"
    losses += ctrl.train_steps(run["between"])
    ctrl.request_resize(ca, overlap="stop_copy")
    while len(ctrl.records) < 2:
        losses += ctrl.train_steps(1)
        assert len(losses) < 400, "the stop-copy resize never committed"
    losses += ctrl.train_steps(run["after"])
    out = {"losses": losses, "params": ctrl.gathered_params(), "cuts": cuts,
           "records": [dataclasses.asdict(r) for r in ctrl.records],
           "commits": [dataclasses.asdict(c) for c in ctrl.rank_commits], "world": ctrl.world.parallel}
    del ctrl

    # the control: split at the first cut's step, moved back after the second's
    split_at, stop_at = cuts[0]["step"], cuts[1]["step"]
    data = SyntheticLM(cfg.vocab_size, seq, global_batch, 0)
    fns = {p: rank_step_fns(cfg, p, opt_cfg, microbatches, groups[p]) for p in (ca, cb) if groups[p].member}
    world, params, opt = ca, None, None
    if groups[ca].member:
        params = shard_params(cfg, M.init_params(cfg, torch.Generator().manual_seed(0), "cpu"), ca, rank)
        opt = init_opt_state(params)
    p_specs = [s for s in specs if s.collection == "params"]
    c_losses = []

    for i in range(len(losses)):
        g = groups[world]
        batch = None
        if g.member:
            batch = {"tokens": torch.from_numpy(data.shard_at(i, g.dp_rank, g.dp)).long()}
        if i == split_at:
            loss, grads = float("nan"), {}
            if g.member:
                loss, _, grads = fns[world][1](params, batch)
                grads = {f"params/{p}": x for p, x in tree_paths(grads).items()}
            moved_grads = _by_hand(pool, rank, p_specs, grads, world, cb)
            params, opt = _carry(pool, rank, specs, params, opt, world, cb)
            world = cb
            if groups[cb].member:
                params, opt, _ = fns[cb][2](tree_from_paths({n[7:]: x for n, x in moved_grads.items()}), opt, params)
            c_losses.append(float(loss))
        else:
            metrics = fns[world][0](params, opt, batch)[2] if g.member else {}
            c_losses.append(float(metrics["loss"]) if g.member else float("nan"))
        if i + 1 == stop_at:
            params, opt = _carry(pool, rank, specs, params, opt, world, ca)
            world = ca
    named = named_state_leaves(params, opt)[0] if params is not None else {}
    control = {}
    for spec, whole in gather_each(pool, named, world, p_specs, "cpu"):
        if whole is not None:
            control[spec.name[len("params/"):]] = whole.numpy()
    out.update(control_losses=c_losses, control_params=control if rank == 0 else None)
    return out


def _carry(pool, rank: int, specs, params, opt, a, b):
    """The state (params, opt_state) on ``a`` carried to ``b`` by
    :func:`_by_hand`; the step count is the pool's agreed (MAX) one, as a
    commit's."""
    from repro_torch.core.reshard import named_state_leaves

    named = named_state_leaves(params, opt)[0] if params is not None else {}
    count = int(pool.agree(int(opt["count"]) if opt is not None else 0, "max"))
    moved = _by_hand(pool, rank, specs, named, a, b)
    if rank >= b.world_size:
        return None, None
    params, opt = _trees(moved)
    opt["count"] = torch.tensor(count, dtype=torch.int32)
    return params, opt


def replica_run(rank: int, pool, cfg, src, dst, microbatches: int, opt_cfg) -> dict:
    """``src`` streamed to ``dst`` with the moments on the int8 wire: this
    rank's state (by tensor name) right after the commit and one step
    later, and the commit's record."""
    from repro_torch.core.rank_controller import RankController
    from repro_torch.reshard import WirePolicy

    ctrl = RankController(cfg, src, opt_cfg, SEQ, BATCH, pool, worlds=[dst], device="cpu",
                          microbatches=microbatches, overlap="stream", stream_k=2, wire_policy=WirePolicy())
    ctrl.train_steps(2)
    ctrl.request_resize(dst)
    while not ctrl.records:
        ctrl.train_steps(1)
    at_commit = {k: v.clone() for k, v in ctrl._named().items()}
    ctrl.train_steps(1)
    return {"at_commit": at_commit, "after": {k: v.clone() for k, v in ctrl._named().items()},
            "record": dataclasses.asdict(ctrl.records[0])}


# ---------------------------------------------------------------------------
# The world
# ---------------------------------------------------------------------------


def _rank_program(rank: int, flat: dict, tokens: np.ndarray, state: dict) -> dict:
    from repro_torch.distribution.groups import RankPool, make_world_groups

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _cfg()
    pool = RankPool()
    groups = make_world_groups(pool, STEP_WORLDS)
    specs = build_tensor_specs(cfg, include_optimizer=True, zero_sharding=False)
    return {"steps": rank_steps(cfg, STEP_WORLDS, groups, rank, flat, tokens, OPT),
            "oracle": oracle_case(rank, pool, specs, SRC, DST, state),
            "run": resize_run(rank, pool, groups, cfg, SRC, DST, RUN, BATCH, SEQ, MB, OPT),
            "replicas": replica_run(rank, pool, cfg, P(pp=2, tp=2), P(dp=2, tp=2), MB, OPT)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    ref = jax_pipeline(tmp_path_factory.mktemp("jax_pipeline"), ARCH)
    flat = {k[6:]: v for k, v in ref.items() if k.startswith("param/")}
    specs = build_tensor_specs(_cfg(), include_optimizer=True, zero_sharding=False)
    rng = np.random.default_rng(3)
    state = {s.name: rng.normal(size=s.shape).astype(s.dtype) for s in specs}
    ranks = run_ranks(_rank_program, 8, flat, ref["tokens"], state, timeout=600)
    return {"ref": ref, "flat": flat, "state": state, "ranks": ranks}


def assembled(ranks: list, i: int, world, specs: dict, what: str = "grads") -> dict:
    """Each leaf of world ``i``'s ``what`` assembled from the ranks that
    hold it."""
    out = {}
    for p, spec in specs.items():
        shards = {r: ranks[r]["steps"][i][what][p] for r in range(world.world_size)
                  if view_of(spec, world, r) is not None}
        out[p] = assemble(shards, spec, world).numpy()
    return out


def param_specs(cfg) -> dict:
    return {s.name[len("params/"):]: s for s in build_tensor_specs(cfg, include_optimizer=False)}


@pytest.fixture(scope="module")
def one_process(world):
    """The port's one-process pp2 world's loss and gradients on the same
    weights and tokens, and the clip's norm of them."""
    from repro_torch.distribution.pipeline import make_pipeline_grad_fn
    from repro_torch.models.convert import params_from_jax
    from repro_torch.optim.adamw import global_norm

    cfg = _cfg()
    loss, _, grads = make_pipeline_grad_fn(cfg, P(pp=2), MB)(params_from_jax(world["flat"], cfg, "cpu"),
                                                             {"tokens": torch.from_numpy(world["ref"]["tokens"]).long()})
    return {"loss": float(loss), "grads": {p: g.numpy() for p, g in tree_paths(grads).items()},
            "norm": float(global_norm(grads))}


@pytest.mark.parametrize("i", range(len(STEP_WORLDS)), ids=IDS)
def test_stage_ranks_equal_the_jax_pipeline(world, one_process, i):
    par, ref = STEP_WORLDS[i], world["ref"]
    for r in range(par.world_size):
        loss = world["ranks"][r]["steps"][i]["loss"]
        np.testing.assert_allclose(loss, float(ref["loss"]), rtol=LOSS_TOL, atol=0)
        np.testing.assert_allclose(loss, one_process["loss"], rtol=LOSS_TOL, atol=0)
    got = assembled(world["ranks"], i, par, param_specs(_cfg()))
    assert sorted(got) == sorted(one_process["grads"])
    for p, g in got.items():
        for want in (ref[f"grad/{p}"], one_process["grads"][p]):
            np.testing.assert_allclose(g, want, rtol=0, atol=GRAD_TOL * np.abs(want).max(), err_msg=p)


@pytest.mark.parametrize("i", range(len(STEP_WORLDS)), ids=IDS)
def test_stage_ranks_hold_their_stage(world, i):
    """Each rank's gradient shards are its view_of boxes: its stage's
    periods, the embedding on stage 0 only, the head and final norm on the
    last stage only."""
    par, specs = STEP_WORLDS[i], param_specs(_cfg())
    for r in range(par.world_size):
        grads = world["ranks"][r]["steps"][i]["grads"]
        stage = par.rank_coords(r)[1]
        assert ("embed/tok" in grads) == (stage == 0)
        assert ("lm_head/w" in grads) == ("final_norm/scale" in grads) == (stage == par.pp - 1)
        for p, g in grads.items():
            assert tuple(g.shape) == view_of(specs[p], par, r).shape(), (r, p)
        assert grads["blocks/pos0/mixer/wq"].shape[0] == _cfg().num_layers // par.pp


@pytest.mark.parametrize("i", range(len(STEP_WORLDS)), ids=IDS)
def test_clip_norm_counts_each_element_once(world, one_process, i):
    par = STEP_WORLDS[i]
    norms = [world["ranks"][r]["steps"][i]["norm"] for r in range(par.world_size)]
    assert len(set(norms)) == 1
    np.testing.assert_allclose(norms[0], one_process["norm"], rtol=NORM_TOL)


@pytest.mark.parametrize("rank", [0, 3])
def test_mock_collectives_equal_a_stage_ranks(world, rank):
    """Stage 0 (rank 0) and the last stage (rank 3) of pp2tp2: the meta run
    under MockGroups records the real rank's sends, receives and
    collectives op for op."""
    from repro_torch.core.mock_groups import mock_warmup
    from repro_torch.core.shadow import rank_meta_args, rank_step_fns

    cfg, par = _cfg(), STEP_WORLDS[0]
    mock = mock_warmup(lambda g: rank_step_fns(cfg, par, OPT, MB, g)[0], par, rank,
                       rank_meta_args(cfg, par, rank, BATCH, SEQ))
    real = world["ranks"][rank]["steps"][0]["collectives"]
    assert mock.collectives == real
    # stage 0 sends each microbatch's activations and receives their
    # gradients; the last stage the other way round
    p2p = [op for op, g, _ in real if g == "pp" and op in ("send", "recv")]
    assert p2p == (["send"] * MB + ["recv"] * MB if rank < 2 else ["recv"] * MB + ["send"] * MB)


def test_rank_executor_moves_the_jax_oracles_bytes(world):
    """dp2pp2tp2 -> dp1pp4tp2 (tests/test_system.py), the whole reduced
    state: every destination shard, each pair's bytes and the engine's
    counters are the JAX package's."""
    from repro.configs import get_config as jax_get_config
    from repro.core.resource_view import build_tensor_specs as jax_specs

    jspecs = jax_specs(jax_get_config(ARCH).reduced(), include_optimizer=True, zero_sharding=False)
    check_against_jax_oracle(world["ranks"], "oracle", jspecs, SRC, DST, world["state"])


def _jax_parallel(p):
    from repro.configs.base import ParallelConfig as JP

    return JP(**dataclasses.asdict(p))


def check_against_jax_oracle(ranks, key, jspecs, ca, cb, state) -> None:
    """The ranks' ``key`` case against ``JS.execute_plan`` of the JAX plan:
    shards bit for bit, pair bytes, counters (clocks and this backend's
    executed bytes aside)."""
    from repro.core import streaming as JS
    from repro.core.intersection import plan_transfer as jax_plan_transfer

    ja, jb = _jax_parallel(ca), _jax_parallel(cb)
    jplan = jax_plan_transfer(jspecs, ja, jb)
    src = {r: JS.materialize_rank(jspecs, ja, r, state) for r in range(ja.world_size)}
    dst = {r: JS.allocate_destination(jspecs, jb, r) for r in range(jb.world_size)}
    jstats = dataclasses.asdict(JS.execute_plan(jplan, src, dst, staging_bytes=STAGING))
    for r in range(len(ranks)):
        got = ranks[r][key]["shards"]
        want = dst[r].shards if r < jb.world_size else {}
        assert sorted(got) == sorted(want), r
        for name, w in want.items():
            np.testing.assert_array_equal(got[name].numpy(), w, err_msg=f"rank {r} {name}")
        stats = dict(ranks[r][key]["stats"])
        for k in ("seconds", "dispatch_seconds", "drain_seconds", "executed_bytes", "generic_cells"):
            stats.pop(k)
        assert stats == {k: v for k, v in jstats.items() if k in stats}, r
        assert ranks[r][key]["stats"]["generic_cells"] == 0
    pairs: dict = {}
    for t in jplan.tasks:
        if t.kind == "remote":
            pairs[(t.src_rank, t.dst_rank)] = pairs.get((t.src_rank, t.dst_rank), 0) + t.nbytes
    got = {(r, d): n for r in range(len(ranks)) for d, n in ranks[r][key]["sent"].items()}
    assert got == pairs and sum(pairs.values()) == jstats["network_bytes"] > 0


def check_resize_run(ranks: list, ca, cb, cfg, jspecs, microbatches: int) -> None:
    """What :func:`resize_run` returned, held (the module docstring)."""
    from conftest import RESHAPE_PARITY_TOL
    from repro.core.intersection import plan_transfer as jax_plan_transfer

    from repro_torch.core.controller import LiveRController

    runs = [r["run"] for r in ranks]
    out = runs[0]
    assert [r["dst"] for r in out["records"]] == [cb.describe(), ca.describe()]
    assert [r["mode"] for r in out["records"]] == ["live_overlap", "live"]
    assert out["world"] == ca
    for cut in out["cuts"]:
        assert cut["exact"] == cut["total"] == len(build_tensor_specs(cfg, zero_sharding=False)), cut
    for r in range(len(runs)):
        assert runs[r]["losses"] == out["losses"] or r >= max(ca.world_size, cb.world_size)
    assert all(np.isfinite(out["losses"]))
    # the stop-copy commit carried the JAX plan's bytes between each pair
    pairs: dict = {}
    for t in jax_plan_transfer(jspecs, _jax_parallel(cb), _jax_parallel(ca)).tasks:
        if t.kind == "remote":
            pairs[(t.src_rank, t.dst_rank)] = pairs.get((t.src_rank, t.dst_rank), 0) + t.nbytes
    got = {(r, d): n for r in range(len(runs)) for d, n in runs[r]["commits"][1]["sent_bytes"].items()}
    assert got == pairs and sum(pairs.values()) == out["records"][1]["plan_network_bytes"] > 0
    # bitwise the control that takes the same worlds' steps
    assert out["control_losses"] == out["losses"]
    got = tree_paths(out["params"])
    assert sorted(got) == sorted(out["control_params"])
    for p, want in out["control_params"].items():
        np.testing.assert_array_equal(got[p], want, err_msg=p)
    # and near a one-process run never resized
    control = LiveRController(cfg, ca, OPT, seq_len=SEQ, global_batch=BATCH, device="cpu", microbatches=microbatches)
    ref_losses = control.train_steps(len(out["losses"]))
    np.testing.assert_allclose(out["losses"], ref_losses, rtol=1e-5)
    ref = tree_paths(control.gathered_params())
    worst = max(float(np.abs(got[p] - ref[p]).max()) for p in ref)
    assert worst < RESHAPE_PARITY_TOL, f"param divergence {worst}"


def test_resize_into_and_out_of_pp_rank_to_rank(world):
    from repro.configs import get_config as jax_get_config
    from repro.core.resource_view import build_tensor_specs as jax_specs

    jspecs = jax_specs(jax_get_config(ARCH).reduced(), include_optimizer=True, zero_sharding=False)
    check_resize_run(world["ranks"], SRC, DST, _cfg(), jspecs, MB)


def test_streamed_commit_splits_the_step(world):
    rec = world["ranks"][0]["run"]["records"][0]
    assert rec["precopy_bytes"] > 0 and rec["update_s"] > 0 and rec["dirty_layers"] > 0
    assert rec["layers_total"] == _cfg().num_layers + 1


def test_int8_commit_leaves_dp_replicas_alike(world):
    """pp2tp2 -> dp2tp2 on the int8 wire: ranks 0 and 2 (and 1 and 3) are
    dp replicas; each got some views over the wire and kept or copied
    others, yet every shard is bitwise its replica's, at the commit and a
    step later."""
    ranks = [world["ranks"][r]["replicas"] for r in range(4)]
    rec = ranks[0]["record"]
    assert rec["dst"] == "dp2xpp1xtp2" and rec["wire_bytes"] < rec["logical_bytes"]
    for a, b in ((0, 2), (1, 3)):
        for when in ("at_commit", "after"):
            got, want = ranks[b][when], ranks[a][when]
            assert sorted(got) == sorted(want)
            for name, x in want.items():
                assert torch.equal(got[name], x), (when, a, b, name)
