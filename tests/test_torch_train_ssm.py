"""Live-resized mamba2 training under the port's ``LiveRController`` on the
CPU: the counterpart of ``tests/test_elastic_e2e.py::
test_scale_in_and_machine_states`` (reduced mamba2-2.7b, dp2tp2 -> dp1tp2
while it trains, the generation machine's phases, the world's size), and
the reduced rehearsal of ``chip_smoke.py``'s ``phase_elastic_train_mamba2``:
a stop-copy scale-in, then a streamed resize back with the split-step
commit, whose losses and state equal a run never resized, bit for bit (one
device: the same tensors through the same code, and exact byte movement)."""

from __future__ import annotations

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ParallelConfig
from repro_torch.core.controller import LiveRController
from repro_torch.core.generations import GenState
from repro_torch.core.reshard import named_state_leaves
from repro_torch.optim import AdamWConfig

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_num_threads(2)

SRC, DST = ParallelConfig(dp=2, tp=2), ParallelConfig(dp=1, tp=2)
KW = dict(seq_len=16, global_batch=4, device="cpu")


def _controller(**kw) -> LiveRController:
    return LiveRController(get_config("mamba2-2.7b").reduced(), SRC, AdamWConfig(), **KW, **kw)


def _train_until_commit(ctrl, losses: list, limit: int = 100) -> None:
    n = len(ctrl.records)
    while len(ctrl.records) == n:
        losses += ctrl.train_steps(1)
        assert len(losses) < limit, "the resize never committed"


@pytest.fixture(scope="module")
def resized():
    """The JAX test's scale-in, then the streamed resize back, the machine's
    history kept after each."""
    ctrl = _controller(stream_k=2)
    losses = ctrl.train_steps(2)
    histories, sizes = [], []
    for target, overlap in ((DST, "stop_copy"), (SRC, "stream")):
        ctrl.request_resize(target, overlap=overlap)
        _train_until_commit(ctrl, losses)
        histories.append([s for s, _ in ctrl.machine.history])
        sizes.append(ctrl.world.parallel.world_size)
        losses += ctrl.train_steps(2)
    return ctrl, losses, histories, sizes


def test_scale_in_and_machine_states(resized):
    ctrl, losses, histories, sizes = resized
    assert sizes == [2, 4]
    assert [(r.mode, r.dst, r.outcome) for r in ctrl.records] == [
        ("live", DST.describe(), "committed"), ("live_overlap", SRC.describe(), "committed")]
    assert ctrl.machine.state is GenState.STABLE
    for phase in ("prepare", "ready", "switch", "cleanup", "stable"):
        assert phase in histories[0], phase
    assert all(torch.isfinite(torch.tensor(losses)))


def test_resized_run_equals_the_unresized_run_bitwise(resized):
    ctrl, losses, _, _ = resized
    control = _controller()
    assert control.train_steps(len(losses)) == losses
    got, _ = named_state_leaves(ctrl.params, ctrl.opt_state)
    want, _ = named_state_leaves(control.params, control.opt_state)
    assert sorted(got) == sorted(want)
    for name, x in want.items():
        assert torch.equal(got[name], x), name


def test_launcher_trains_and_resizes_mamba2(tmp_path, monkeypatch, capsys):
    """``python -m repro_torch.launch.train --arch mamba2-2.7b`` at reduced
    size on the CPU: it trains, takes a live scale-in mid-run, and writes
    its record."""
    import json
    import sys

    from repro_torch.launch import train

    out = tmp_path / "run.json"
    monkeypatch.setattr(sys, "argv", [
        "train", "--arch", "mamba2-2.7b", "--reduced", "--device", "cpu", "--dp", "2", "--tp", "2",
        "--steps", "8", "--seq", "16", "--batch", "4", "--resize", "2:dp1,tp2", "--out", str(out),
    ])
    train.main()
    assert "[done] 8 steps" in capsys.readouterr().out
    rec = json.loads(out.read_text())
    assert rec["arch"] == get_config("mamba2-2.7b").reduced().name and rec["device"] == "cpu"
    assert len(rec["losses"]) == 8 and all(torch.isfinite(torch.tensor(rec["losses"])))
    assert [(r["src"], r["dst"]) for r in rec["reconfigs"]] == [(SRC.describe(), DST.describe())]
