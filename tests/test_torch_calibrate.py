"""``utils/timing.py`` against the JAX package's, and ``sim/calibrate.py``
on the CPU: every constant measured and positive, the JSON cache read
back, ``force`` measuring anew; neither module imports jax."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

from repro.utils import timing as jax_timing
from repro_torch.sim import calibrate
from repro_torch.utils import timing

SRC = Path(__file__).resolve().parents[1] / "src"


def _clock():
    ticks = iter(range(1000))
    return lambda: 0.25 * next(ticks)


def test_timer_equals_the_jax_timer(monkeypatch):
    """The same phases on the same stubbed clock: equal totals, counts and
    report."""
    monkeypatch.setattr(jax_timing, "now", _clock())
    monkeypatch.setattr(timing, "now", _clock())
    timers = (jax_timing.Timer(), timing.Timer())
    for t in timers:
        for name in ("compile", "transfer", "compile", "switch"):
            with t.phase(name):
                pass
    a, b = timers
    assert a.totals == b.totals == {"compile": 0.5, "transfer": 0.25, "switch": 0.25}
    assert a.counts == b.counts == {"compile": 2, "transfer": 1, "switch": 1}
    assert a.report() == b.report()
    assert timing.now is not jax_timing.now


def test_measure_on_the_cpu_caches_and_forces(tmp_path, monkeypatch):
    cache = tmp_path / "calibration_torch.json"
    consts = calibrate.measure(device="cpu", cache=str(cache))
    assert consts["device"] == "cpu"
    for key in calibrate.KEYS:
        assert consts[key] > 0, key
    assert json.loads(cache.read_text()) == consts
    # a second call reads the cache: nothing is measured
    monkeypatch.setattr(calibrate, "_measure", lambda device: pytest.fail("measured again"))
    assert calibrate.measure(device="cpu", cache=str(cache)) == consts
    # force measures anew and rewrites the cache
    fresh = dict(consts, proc_spawn_s=consts["proc_spawn_s"] + 1.0)
    monkeypatch.setattr(calibrate, "_measure", lambda device: fresh)
    assert calibrate.measure(force=True, device="cpu", cache=str(cache)) == fresh
    assert json.loads(cache.read_text()) == fresh


def test_default_cache_is_not_the_jax_packages():
    assert Path(calibrate.CACHE).name == "calibration_torch.json"
    assert Path(calibrate.CACHE).parent == SRC.parent / "results"


def test_measure_refuses_a_missing_card(tmp_path, monkeypatch):
    monkeypatch.setattr(calibrate.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calibrate.measure(force=True, cache=str(tmp_path / "c.json"))


def test_the_modules_import_no_jax():
    code = ("import sys; import repro_torch.sim.calibrate, repro_torch.utils.timing; "
            "print(sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'repro.')) or m == 'repro'))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True,
                         env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})
    assert out.stdout.strip() == "[]"
