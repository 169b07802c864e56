"""Fail-stop recovery on per-rank worlds (``core/rank_controller.py``,
``elastic/redundancy.py::RankParityStore``, ``checkpoint/ckpt.py``'s
per-rank save), in one gloo world of 4 CPU rank processes, against the JAX
package and against per-rank controls.

Reduced qwen3-1.7b (seq 32, batch 8, f32) from the JAX package's seed-0
weights (``params_from_jax``). A lost rank's process stays up; its state is
poisoned and freed (``FaultInjector.kill`` -> ``RankController.lose_state``)
before the recovery begins. Each case starts from a fresh controller:

- DP donors: dp2tp2 loses ranks 2 and 3 (a suffix: nothing moves) and
  ranks 0 and 1 (inside the target world dp1tp2: they come back as
  replacements fed by donors 2 and 3);
- the parity spare: dp1tp4 refreshing its XOR word every step loses rank
  3, rebuilt from the word on its healed owner, into dp1tp2;
- the fault matrix under ``WirePolicy()``: a stream dp2tp2 -> dp1tp4 hit
  idle, mid-stream and mid-commit by the loss of ranks 2 and 3, each
  recovered into dp1tp2 with no quant launch;
- the checkpoint rung: dp1tp4, ``checkpoint_now`` at step 2, rank 3 lost at
  step 4 without parity: restored and rolled back to step 2.

Each recovered state is bit for bit the state at the cut (the checkpoint's
step for the rung), assembled; the next 2 steps are bitwise those of a
per-rank control that reached the same world by plain copies at the same
step. Each case's bytes by rank pair equal the JAX survivor-constrained,
donor-balanced (healed) plan's; the assembled parity words and the repaired
bytes equal the JAX ``ParityStore``'s; the checkpoint's files load with the
JAX ``load_checkpoint`` and equal the one-process port's save of the
assembled state. Every rank raises the typed ``RecoveryError`` when no rung
is left (no checkpoint directory, no durable checkpoint, two groups of one
tensor lost), and none hangs. The launcher's ``--nproc`` with
``--ckpt-dir`` and ``--failstop``, and its refusal of ``--compression``."""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ParallelConfig as P
from repro_torch.core.resource_view import build_tensor_specs
from repro_torch.launch.ranks import run_ranks
from repro_torch.models.convert import params_from_jax
from repro_torch.utils.pytree import tree_from_paths, tree_paths
from test_torch_rank_lifecycle import BATCH, CFG, NPROC, OPT, SEQ, world_control

torch.set_num_threads(2)

SPECS = build_tensor_specs(CFG, include_optimizer=True, zero_sharding=False)
WORLDS = [P(dp=2, tp=2), P(dp=1, tp=4), P(dp=1, tp=2)]
DP2TP2, DP1TP4, DP1TP2 = WORLDS
# name: (source, steps before the loss, lost ranks, target, controller options, fault phase)
CASES = {
    "donors_suffix": (DP2TP2, 3, (2, 3), DP1TP2, {}, None),
    "donors_inside": (DP2TP2, 3, (0, 1), DP1TP2, {}, None),
    "parity": (DP1TP4, 3, (3,), DP1TP2, {"parity_every": 1}, None),
    "idle": (DP2TP2, 3, (2, 3), DP1TP2, {"overlap": "stream", "stream_k": 2, "wire": True}, "idle"),
    "mid_stream": (DP2TP2, 3, (2, 3), DP1TP2, {"overlap": "stream", "stream_k": 2, "wire": True}, "mid_stream"),
    "mid_commit": (DP2TP2, 3, (2, 3), DP1TP2, {"overlap": "stream", "stream_k": 2, "wire": True}, "mid_commit"),
}
AFTER = 2


def _assembled(c, specs=SPECS) -> dict:
    """The state on rank 0 (params and moments by name, the step count),
    None elsewhere."""
    from repro_torch.core.rank_controller import gather_each

    out = {}
    for spec, whole in gather_each(c.pool, c._named(), c.world.parallel, specs, "cpu"):
        if whole is not None:
            out[spec.name] = whole.numpy().copy()
    count = int(c.pool.agree(int(c.opt_state["count"]) if c.opt_state is not None else 0, "max"))
    return {**out, "count": count} if c.rank == 0 else None


def _quant_counted(c, calls: list):
    """``c.fail_stop_recover`` counting the quant kernels' calls inside it."""
    from repro_torch.kernels import ops

    recover = c.fail_stop_recover

    def counted(*args, **kwargs):
        orig = (ops.pack_quant_rows, ops.dequant_scatter_rows)
        ops.pack_quant_rows = lambda *a, **k: calls.append(1) or orig[0](*a, **k)
        ops.dequant_scatter_rows = lambda *a, **k: calls.append(1) or orig[1](*a, **k)
        try:
            return recover(*args, **kwargs)
        finally:
            ops.pack_quant_rows, ops.dequant_scatter_rows = orig

    c.fail_stop_recover = counted


def _held_after_loss(c, out: dict) -> None:
    """``c.lose_state`` recording into ``out["held_after_loss"]`` the
    bytes of storage the state, the session and the parity word still hold
    on this rank once it has run."""
    lose = c.lose_state
    held = [*c._named().values()]

    def counted(lost):
        nonlocal held
        if c._session is not None:
            held += [*c._session.executor.dst.values(), *c._session.executor.dst_buffers.values()]
        if c._parity is not None:
            held.append(c._parity.word)
        lose(lost)
        out["held_after_loss"] = sum(t.untyped_storage().nbytes() for t in held) if c.rank in lost else None
        out["poisoned"] = c.rank in lost and all(
            bool(torch.isnan(t).all()) for t in held if t.untyped_storage().nbytes() and t.is_floating_point())
        held = []

    c.lose_state = counted


def _case(pool, rank: int, params, name: str) -> dict:
    from repro_torch.core.rank_controller import RankController
    from repro_torch.elastic import FaultInjector, RankParityStore
    from repro_torch.reshard import WirePolicy

    src, before, lost, target, opts, phase = CASES[name]
    opts = dict(opts)
    wire = WirePolicy() if opts.pop("wire", False) else None
    c = RankController(CFG, src, OPT, SEQ, BATCH, pool, worlds=WORLDS, device="cpu", params=params,
                       wire_policy=wire, **opts)
    out: dict = {}
    repaired = {}
    orig_repair = RankParityStore.repair

    def repair(self, named, lost_ranks, step):
        named, n = orig_repair(self, named, lost_ranks, step)
        repaired.update({k: v.numpy().copy() for k, v in named.items() if self.rank == min(lost_ranks)})
        return named, n

    RankParityStore.repair = repair
    calls: list = []
    _quant_counted(c, calls)
    _held_after_loss(c, out)
    inj = FaultInjector(c)
    try:
        c.train_steps(before)
        if phase in ("mid_stream", "mid_commit"):
            c.request_resize(DP1TP4, overlap="stream")
            c.wait_shadow_ready()
            assert inj.run_until(phase)
        if c._parity is not None:
            out["words"] = {k: w.numpy().copy() for k, w in c._parity._parity.items()} if rank == 0 else None
            out["refresh"] = (c._parity.step, c._parity.refreshed_bytes, c._parity.last_refresh_s)
        out["cut"] = _assembled(c)
        out["cut_step"] = c.step
        rep = inj.kill(target, lost_ranks=lost, expect_phase=phase)
    finally:
        RankParityStore.repair = orig_repair
    out["report"] = dataclasses.asdict(rep)
    out["record"] = dataclasses.asdict(c.records[-1])
    out["commit"] = dataclasses.asdict(c.rank_commits[-1])
    out["quant_calls"] = len(calls)
    out["repaired"] = repaired
    out["recovered"] = _assembled(c)
    out["world"] = c.world.parallel
    out["pending"] = c.reconfig_pending
    out["losses"] = c.train_steps(AFTER)
    out["params"] = c.gathered_params()
    del c
    out["control"] = world_control(pool, rank, params, src, [("stop", out["cut_step"], target)],
                                   out["cut_step"] + AFTER)
    return out


def _checkpoint_case(pool, rank: int, params, ckpt_dir: str) -> dict:
    from repro_torch.core.rank_controller import RankController
    from repro_torch.elastic import FaultInjector

    c = RankController(CFG, DP1TP4, OPT, SEQ, BATCH, pool, worlds=WORLDS, device="cpu", params=params,
                       ckpt_dir=ckpt_dir)
    c.train_steps(2)
    c.checkpoint_now()
    out = {"saved": _assembled(c), "save_s": (c._ckpt.last_snapshot_seconds, c._ckpt.last_save_seconds)}
    c.train_steps(2)
    rep = FaultInjector(c).kill(DP1TP2, lost_ranks=(3,))
    out.update(report=dataclasses.asdict(rep), record=dataclasses.asdict(c.records[-1]), recovered=_assembled(c),
               world=c.world.parallel, losses=c.train_steps(AFTER), params=c.gathered_params())
    del c
    out["control"] = world_control(pool, rank, params, DP1TP4, [("stop", 2, DP1TP2)], 2 + AFTER)
    return out


def _no_rung(pool, rank: int, params, tmp: str) -> list:
    """Each rung left empty: the error's type and text on this rank."""
    from repro_torch.core.errors import RecoveryError
    from repro_torch.core.rank_controller import RankController
    from repro_torch.elastic import FaultInjector

    got = []
    for opts, lost in (({}, (3,)), ({"ckpt_dir": os.path.join(tmp, "empty")}, (3,)), ({"parity_every": 1}, (2, 3))):
        c = RankController(CFG, DP1TP4, OPT, SEQ, BATCH, pool, worlds=WORLDS, device="cpu", params=params, **opts)
        c.train_steps(1)
        try:
            FaultInjector(c).kill(DP1TP2, lost_ranks=lost)
            got.append(None)
        except RecoveryError as e:
            got.append(str(e))
        del c
    return got


def _rank_program(rank: int, flat: dict, tmp: str) -> dict:
    from repro_torch.distribution.groups import RankPool

    pool = RankPool()
    params = params_from_jax(flat, CFG, "cpu")
    out = {name: _case(pool, rank, params, name) for name in CASES}
    out["checkpoint"] = _checkpoint_case(pool, rank, params, os.path.join(tmp, "ckpt"))
    out["no_rung"] = _no_rung(pool, rank, params, tmp)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case on the ranks, from the JAX package's seed-0 weights (its
    controller's init, ``init_train_state``)."""
    import jax

    from repro.configs import get_config as jax_get_config
    from repro.models import model as JM
    from repro.utils.pytree import tree_paths as jax_tree_paths

    jparams = jax.jit(lambda rng: JM.init_params(jax_get_config("qwen3-1.7b").reduced(), rng))(jax.random.key(0))
    flat = {p: np.asarray(x) for p, x in jax_tree_paths(jparams).items()}
    params_from_jax(flat, CFG, "cpu")  # the paths and shapes are the port's
    tmp = tmp_path_factory.mktemp("rank_recovery")
    return run_ranks(_rank_program, NPROC, flat, str(tmp), timeout=600), tmp


def _jax_pairs(src, dst, lost) -> dict:
    """Bytes by (source, destination) rank of the JAX package's recovery
    plan: survivor-constrained, healed where cells were lost, donor-balanced."""
    from repro import configs as jax_configs
    from repro.core.reshard import plan_state_transfer as jax_plan
    from repro.elastic import redundancy as JRD

    JP = jax_configs.ParallelConfig
    jcfg = jax_configs.get_config("qwen3-1.7b").reduced()
    s, d = JP(dp=src.dp, tp=src.tp), JP(dp=dst.dp, tp=dst.tp)
    survivors = JRD.survivors_for(s, lost, target=d)
    specs, plan = jax_plan(jcfg, s, d, allowed_src=survivors)
    if plan.lost_tasks():
        plan, _ = JRD.heal_plan(plan, specs)
    plan = JRD.balance_donors(plan, specs, survivors)
    pairs: dict = {}
    for t in plan.tasks:
        if t.kind != "resident" and t.src_rank != t.dst_rank:
            pairs[(t.src_rank, t.dst_rank)] = pairs.get((t.src_rank, t.dst_rank), 0) + t.nbytes
    return pairs


def _pairs(rs, key) -> dict:
    return {(i, int(d)): n for i, r in enumerate(rs) for d, n in r[key]["commit"]["sent_bytes"].items() if n}


def _assert_state_equal(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_recovery_is_bitwise_the_cut_and_the_control(ranks, name):
    rs, _ = ranks
    r0 = rs[0][name]
    src, before, lost, target, _, phase = CASES[name]
    assert (r0["report"]["mode"], r0["report"]["outcome"]) == ("peer_recover", "committed")
    assert r0["report"]["step_before"] == r0["report"]["step_after"] == r0["cut_step"]
    assert r0["world"] == target and not r0["pending"]
    _assert_state_equal(r0["recovered"], r0["cut"])
    assert r0["losses"] == r0["control"]["losses"][-AFTER:]
    got, want = tree_paths(r0["params"]), tree_paths(r0["control"]["params"])
    assert got.keys() == want.keys() and all(np.array_equal(got[k], want[k]) for k in want)
    for r in rs:  # every rank saw the same recovery
        assert r[name]["record"]["mode"] == "peer_recover" and r[name]["world"] == target


@pytest.mark.parametrize("name", list(CASES))
def test_bytes_by_rank_pair_are_the_jax_recovery_plans(ranks, name):
    rs, _ = ranks
    src, before, lost, target, _, phase = CASES[name]
    pairs = _pairs(rs, name)
    assert pairs == _jax_pairs(src, target, lost)
    healed = {3} if name == "parity" else set()
    assert not {a for a, _ in pairs} & (set(lost) - healed), "a byte sourced from a lost rank"
    for i in lost:  # every lost rank's state went before the recovery: freed, or where its
        # storage cannot be freed (the pinned host word), poisoned
        assert rs[i][name]["held_after_loss"] in (0, None) or rs[i][name]["poisoned"]


def test_dp_donors_feed_the_replacements(ranks):
    rs, _ = ranks
    assert _pairs(rs, "donors_suffix") == {}
    pairs = _pairs(rs, "donors_inside")
    assert {a for a, _ in pairs} == {2, 3} and {b for _, b in pairs} == {0, 1}
    assert rs[0]["donors_inside"]["record"]["donors"] == 2 and rs[0]["donors_inside"]["record"]["lost_devices"] == 2


def test_parity_words_and_repaired_bytes_equal_jax(ranks):
    from repro import configs as jax_configs
    from repro.core.resource_view import build_tensor_specs as jax_specs
    from repro.elastic import redundancy as JRD

    rs, _ = ranks
    r0 = rs[0]["parity"]
    step, nbytes, seconds = r0["refresh"]
    assert step == r0["cut_step"] and seconds > 0
    jspecs = jax_specs(jax_configs.get_config("qwen3-1.7b").reduced(), include_optimizer=True, zero_sharding=False)
    jcfg = jax_configs.ParallelConfig(dp=1, tp=4)
    cut = {k: v for k, v in r0["cut"].items() if k != "count"}
    store = JRD.ParityStore(jspecs, jcfg)
    assert store.refresh({k: v.copy() for k, v in cut.items()}, step=step) == nbytes
    assert sorted(store._parity) == sorted(r0["words"])
    for k, w in store._parity.items():
        np.testing.assert_array_equal(r0["words"][k], w, err_msg=k)
    # every rank holds the whole word
    assert all(r["parity"]["refresh"][1] == nbytes for r in rs)
    poisoned = {k: v.copy() for k, v in cut.items()}
    for s in jspecs:
        for bounds, owners in JRD._shard_groups(s, jcfg):
            if owners == [3]:
                poisoned[s.name][tuple(slice(lo, hi) for lo, hi in bounds)] = np.nan
    patched, n = store.repair(poisoned, frozenset({3}), step=step)
    repaired = rs[3]["parity"]["repaired"]
    assert n == rs[0]["parity"]["record"]["parity_bytes"] > 0 and repaired
    for name, shard in repaired.items():
        [(bounds, _)] = [(b, o) for b, o in JRD._shard_groups(next(s for s in jspecs if s.name == name), jcfg)
                         if o == [3]]
        region = np.asarray(patched[name])[tuple(slice(lo, hi) for lo, hi in bounds)]
        np.testing.assert_array_equal(shard, region, err_msg=name)
        np.testing.assert_array_equal(shard, cut[name][tuple(slice(lo, hi) for lo, hi in bounds)], err_msg=name)


def test_fault_matrix_recovers_with_no_quant_launch(ranks):
    rs, _ = ranks
    for phase in ("idle", "mid_stream", "mid_commit"):
        for r in rs:
            got = r[phase]
            assert got["report"]["phase"] == phase and got["quant_calls"] == 0
            assert got["record"]["wire_bytes"] == got["record"]["logical_bytes"]


def test_checkpoint_rung_rolls_back_bitwise(ranks):
    rs, _ = ranks
    r0 = rs[0]["checkpoint"]
    assert (r0["report"]["mode"], r0["report"]["outcome"], r0["report"]["step_before"], r0["report"]["step_after"]) \
        == ("fallback", "fell_back", 4, 2)
    assert r0["world"] == DP1TP2 and all(x is not None and x > 0 for x in r0["save_s"])
    _assert_state_equal(r0["recovered"], r0["saved"])
    assert r0["losses"] == r0["control"]["losses"][-AFTER:]
    got, want = tree_paths(r0["params"]), tree_paths(r0["control"]["params"])
    assert got.keys() == want.keys() and all(np.array_equal(got[k], want[k]) for k in want)


def test_rank_checkpoint_loads_with_jax_and_equals_the_one_process_save(ranks, tmp_path):
    import jax.numpy as jnp

    from repro.checkpoint import ckpt as jax_ckpt
    from repro_torch.checkpoint import save_checkpoint

    rs, tmp = ranks
    ckpt_dir = str(tmp / "ckpt")
    assert sorted(os.listdir(ckpt_dir)) == ["step_00000002"]
    saved = rs[0]["checkpoint"]["saved"]
    paths = [s.name[len("params/"):] for s in SPECS if s.collection == "params"]
    state = {"params": tree_from_paths({p: torch.from_numpy(saved[f"params/{p}"]) for p in paths}),
             "opt": {"mu": tree_from_paths({p: torch.from_numpy(saved[f"mu/{p}"]) for p in paths}),
                     "nu": tree_from_paths({p: torch.from_numpy(saved[f"nu/{p}"]) for p in paths}),
                     "count": torch.tensor(saved["count"], dtype=torch.int32)}}
    save_checkpoint(str(tmp_path), 2, state)
    step_dir, one_dir = os.path.join(ckpt_dir, "step_00000002"), str(tmp_path / "step_00000002")
    with open(os.path.join(step_dir, "manifest.json")) as f, open(os.path.join(one_dir, "manifest.json")) as g:
        assert json.load(f) == json.load(g)
    assert sorted(os.listdir(step_dir)) == sorted(os.listdir(one_dir))
    for fname in os.listdir(one_dir):
        if fname.endswith(".npy"):
            np.testing.assert_array_equal(np.load(os.path.join(step_dir, fname)), np.load(os.path.join(one_dir, fname)))
    like = {"params": tree_from_paths({p: jnp.zeros(1, jnp.float32) for p in paths}),
            "opt": {"mu": tree_from_paths({p: jnp.zeros(1, jnp.float32) for p in paths}),
                    "nu": tree_from_paths({p: jnp.zeros(1, jnp.float32) for p in paths}),
                    "count": jnp.zeros((), jnp.int32)}}
    loaded, step, _ = jax_ckpt.load_checkpoint(ckpt_dir, like)
    assert step == 2
    for path, x in tree_paths(loaded).items():
        name = path[len("opt/"):] if path.startswith("opt/") else path
        np.testing.assert_array_equal(np.asarray(x), saved[name] if name != "count" else saved["count"], err_msg=path)


def test_every_rank_raises_recovery_error_when_no_rung_is_left(ranks):
    rs, _ = ranks
    for r in rs:
        a, b, c = r["no_rung"]
        assert a is not None and "no checkpoint directory" in a
        assert b is not None and "no durable checkpoint" in b
        assert c is not None and "single XOR parity" in c


@pytest.mark.parametrize("dp,tp,mode", [(2, 2, "peer_recover"), (1, 4, "fallback")])
def test_launcher_checkpoints_and_recovers_on_ranks(tmp_path, monkeypatch, capfd, dp, tp, mode):
    from repro_torch.launch import train

    monkeypatch.setattr(sys, "argv", [
        "train", "--arch", "qwen3-1.7b", "--reduced", "--device", "cpu", "--nproc", "4", "--dp", str(dp),
        "--tp", str(tp), "--steps", "12", "--seq", "16", "--batch", "4", "--ckpt-dir", str(tmp_path),
        "--ckpt-interval", "5", "--failstop", "8:dp1,tp2",
    ])
    train.main()
    out = capfd.readouterr().out  # rank 0's process prints
    assert f"recovered via {mode}" in out and "[done] 12 steps" in out
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000005", "step_00000010"]


def test_launcher_still_refuses_compression_on_ranks(monkeypatch):
    from repro_torch.launch import train

    monkeypatch.setattr(sys, "argv", ["train", "--reduced", "--device", "cpu", "--nproc", "4",
                                      "--compression", "int8_ef"])
    with pytest.raises(SystemExit):
        train.main()
