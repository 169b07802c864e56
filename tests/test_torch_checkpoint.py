"""The port's checkpoint subsystem (``repro_torch/checkpoint``) on the CPU:
the round trip, ``latest_step``, the atomic publish, the background write's
error surfacing at the next ``save``/``wait``, a snapshot that the next
in-place update cannot change, loading into the live tensors, and the
on-disk format shared with the JAX package (``tests/test_checkpoint.py``):
a checkpoint either package writes, the other loads, for float32 and int32
leaves."""

from __future__ import annotations

import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as JC
from repro_torch.checkpoint import AsyncCheckpointer, latest_step, load_checkpoint, save_checkpoint
from repro_torch.checkpoint import ckpt as C
from repro_torch.utils.pytree import tree_paths as _flat


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {
            "w": torch.randn(16, 8, generator=g), "b": torch.zeros(8), "h": torch.randn(4, 3, generator=g).bfloat16(),
        },
        "opt": {"count": torch.tensor(5, dtype=torch.int32), "mu": {"w": torch.randn(16, 8, generator=g)}},
    }


def _assert_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k


def test_roundtrip(tmp_path):
    state = _state()
    assert save_checkpoint(str(tmp_path), 42, state) > 0
    assert latest_step(str(tmp_path)) == 42
    loaded, step, seconds = load_checkpoint(str(tmp_path), state)
    assert step == 42 and seconds > 0
    _assert_equal(loaded, state)
    manifest = json.loads((tmp_path / "step_00000042" / C.MANIFEST).read_text())
    assert manifest["tensors"]["params/h"]["dtype"] == "bfloat16"  # stored as its bits, no ml_dtypes
    assert np.load(tmp_path / "step_00000042" / "params__h.npy").dtype == np.uint16
    assert manifest["tensors"]["opt/count"] == {"shape": [], "dtype": "int32", "file": "opt__count.npy"}


def test_latest_step_picks_max_and_ignores_tmp(tmp_path):
    assert latest_step(str(tmp_path / "none")) is None
    for step in (1, 12, 7):
        save_checkpoint(str(tmp_path), step, _state())
    os.makedirs(tmp_path / "step_00000099.tmp")  # an unpublished write
    assert latest_step(str(tmp_path)) == 12


def test_atomic_publish(tmp_path):
    save_checkpoint(str(tmp_path), 9, _state())
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))
    save_checkpoint(str(tmp_path), 9, _state(seed=1))  # republished whole
    loaded, _, _ = load_checkpoint(str(tmp_path), _state())
    _assert_equal(loaded, _state(seed=1))


def test_load_into_the_live_tensors(tmp_path):
    save_checkpoint(str(tmp_path), 3, _state())
    live = _state(seed=1)
    ptrs = {k: v.data_ptr() for k, v in _flat(live).items()}
    loaded, step, _ = load_checkpoint(str(tmp_path), live, in_place=True)
    assert step == 3 and {k: v.data_ptr() for k, v in _flat(loaded).items()} == ptrs
    _assert_equal(live, _state())


def test_async_write_error_surfaces_at_the_next_wait(tmp_path):
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("occupied")  # the writer's makedirs fails
    ck = AsyncCheckpointer(str(blocker))
    ck.save(1, {"w": torch.ones(4)})
    with pytest.raises(RuntimeError, match="async checkpoint write"):
        ck.wait()
    ck.wait()  # the error is consumed
    ok = AsyncCheckpointer(str(tmp_path / "ckpts"))
    ok.save(2, {"w": torch.ones(4)})
    ok.wait()
    assert os.path.isdir(tmp_path / "ckpts" / "step_00000002")
    assert ok.last_snapshot_seconds is not None and ok.last_save_seconds is not None


def test_async_snapshot_is_not_changed_by_the_next_in_place_step(tmp_path, monkeypatch):
    """The writer runs after the state's next in-place update (held here
    by a gate): it still writes the snapshot's bytes."""
    gate = threading.Event()
    write = C._write
    monkeypatch.setattr(C, "_write", lambda *a: gate.wait(10) and write(*a))
    state = _state()
    want = {k: v.clone() for k, v in _flat(state).items()}
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save(4, state)
    for x in _flat(state).values():
        x.add_(1)  # the optimizer's in-place update
    gate.set()
    ck.wait()
    loaded, _, _ = load_checkpoint(str(tmp_path), state)
    for k, v in _flat(loaded).items():
        assert torch.equal(v, want[k]), k


def _cross_state():
    rng = np.random.default_rng(3)
    return {
        "params": {"w": rng.standard_normal((16, 8)).astype(np.float32), "b": np.zeros(8, np.float32)},
        "opt": {"count": np.int32(7), "steps": np.arange(6, dtype=np.int32)},
    }


def test_a_port_checkpoint_loads_in_the_jax_package(tmp_path):
    ref = _cross_state()
    save_checkpoint(str(tmp_path), 11, {k: {p: torch.from_numpy(np.array(v)) for p, v in sub.items()}
                                        for k, sub in ref.items()})
    like = jax.tree_util.tree_map(jnp.asarray, ref)
    loaded, step, _ = JC.load_checkpoint(str(tmp_path), like)
    assert step == 11 == JC.latest_step(str(tmp_path))
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(loaded), jax.tree_util.tree_leaves_with_path(like)):
        assert pa == pb and a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_a_jax_checkpoint_loads_in_the_port(tmp_path):
    ref = _cross_state()
    JC.save_checkpoint(str(tmp_path), 13, jax.tree_util.tree_map(jnp.asarray, ref))
    like = {k: {p: torch.zeros(np.shape(v), dtype=getattr(torch, str(np.asarray(v).dtype))) for p, v in sub.items()}
            for k, sub in ref.items()}
    loaded, step, _ = load_checkpoint(str(tmp_path), like)
    assert step == 13 == latest_step(str(tmp_path))
    for k, sub in ref.items():
        for p, v in sub.items():
            assert loaded[k][p].dtype == like[k][p].dtype
            np.testing.assert_array_equal(loaded[k][p].numpy(), np.asarray(v), err_msg=f"{k}/{p}")
