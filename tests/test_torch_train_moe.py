"""Live-resized MoE training under the port's ``LiveRController`` on the
CPU: reduced mixtral-8x7b (its aux loss in the loss) resized while it
trains through the expert-parallel degrees of ``chip_smoke.py``'s
mixtral training phase and of ``tests/test_system.py``'s EP reshape
(dp2tp2 -> dp2tp2ep2 streamed with the split-step commit -> dp1tp2ep4 by
stop-copy -> dp1tp4 streamed), whose losses and state equal a run never
resized, bit for bit (one device: the same tensors through the same code,
and exact byte movement); and the launcher with an ``ep`` resize."""

from __future__ import annotations

import json
import sys

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ParallelConfig
from repro_torch.core.controller import LiveRController
from repro_torch.core.reshard import named_state_leaves
from repro_torch.optim import AdamWConfig

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_num_threads(2)

ARCH = "mixtral-8x7b"
SRC = ParallelConfig(dp=2, tp=2)
RESIZES = [(ParallelConfig(dp=2, tp=2, ep=2), "stream"), (ParallelConfig(dp=1, tp=2, ep=4), "stop_copy"),
           (ParallelConfig(dp=1, tp=4), "stream")]
KW = dict(seq_len=16, global_batch=4, device="cpu")


def _controller(**kw) -> LiveRController:
    return LiveRController(get_config(ARCH).reduced(), SRC, AdamWConfig(), **KW, **kw)


@pytest.fixture(scope="module")
def resized():
    ctrl = _controller(stream_k=2)
    losses = ctrl.train_steps(2)
    for target, overlap in RESIZES:
        ctrl.request_resize(target, overlap=overlap)
        n = len(ctrl.records)
        while len(ctrl.records) == n:
            losses += ctrl.train_steps(1)
            assert len(losses) < 60, "the resize never committed"
        losses += ctrl.train_steps(1)
    return ctrl, losses


def test_expert_parallel_resizes_commit(resized):
    ctrl, losses = resized
    assert [(r.mode, r.dst, r.outcome) for r in ctrl.records] == [
        ("live_overlap", RESIZES[0][0].describe(), "committed"), ("live", RESIZES[1][0].describe(), "committed"),
        ("live_overlap", RESIZES[2][0].describe(), "committed")]
    assert ctrl.world.parallel == RESIZES[-1][0]
    assert all(r.moved_bytes > 0 for r in ctrl.records)
    assert all(torch.isfinite(torch.tensor(losses)))


def test_resized_run_equals_the_unresized_run_bitwise(resized):
    ctrl, losses = resized
    control = _controller()
    assert control.train_steps(len(losses)) == losses
    got, _ = named_state_leaves(ctrl.params, ctrl.opt_state)
    want, _ = named_state_leaves(control.params, control.opt_state)
    assert sorted(got) == sorted(want) and any("/mlp/wi_gate" in n for n in want)
    for name, x in want.items():
        assert torch.equal(got[name], x), name


def test_launcher_trains_and_resizes_mixtral_across_ep(tmp_path, monkeypatch, capsys):
    from repro_torch.launch import train

    out = tmp_path / "run.json"
    monkeypatch.setattr(sys, "argv", [
        "train", "--arch", ARCH, "--reduced", "--device", "cpu", "--dp", "2", "--tp", "2",
        "--steps", "6", "--seq", "16", "--batch", "4", "--resize", "2:dp2,tp2,ep2", "--out", str(out),
    ])
    train.main()
    assert "[done] 6 steps" in capsys.readouterr().out
    rec = json.loads(out.read_text())
    assert len(rec["losses"]) == 6 and all(torch.isfinite(torch.tensor(rec["losses"])))
    assert [(r["src"], r["dst"]) for r in rec["reconfigs"]] == [(SRC.describe(), RESIZES[0][0].describe())]
