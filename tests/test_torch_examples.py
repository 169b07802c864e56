"""The port's serving example on the CPU: ``examples/serve_decode_torch.py
--device cpu`` serves reduced qwen3, mixtral and mamba2 through
``serve_once``, and the tokens it prints are those of the same call made
here."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

from repro_torch.configs import get_config
from repro_torch.serve.driver import serve_once

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_serve_decode_example_on_cpu():
    res = subprocess.run([sys.executable, os.path.join("examples", "serve_decode_torch.py"), "--device", "cpu"],
                         capture_output=True, text=True, timeout=300, cwd=REPO)
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    assert [line.split()[0] for line in lines] == ["qwen3-1.7b", "mixtral-8x7b", "mamba2-2.7b"]
    torch.set_num_threads(2)
    for line in lines:
        arch = line.split()[0]
        toks = serve_once(get_config(arch).reduced(), batch=2, prompt_len=32, gen=8, device="cpu")["tokens"]
        assert "generated 9 tokens/request" in line
        assert line.endswith(str([int(t) for t in toks[0][:8]])), line


# ---------------------------------------------------------------------------
# quickstart, reshard demo, fleet: the torch examples beside the JAX ones
# ---------------------------------------------------------------------------

CPU_ENV = {**os.environ, "OMP_NUM_THREADS": "2", "PYTHONPATH": os.path.join(REPO, "src"), "JAX_PLATFORMS": "cpu"}


def _run(script: str, *args: str, timeout: int = 300, env=None) -> str:
    res = subprocess.run([sys.executable, os.path.join("examples", script), *args], capture_output=True, text=True,
                         timeout=timeout, cwd=REPO, env=env or CPU_ENV)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout


def test_quickstart_example_on_cpu_equals_a_direct_call():
    # one thread: the CPU's reductions over two threads do not repeat bit for bit
    env = {**CPU_ENV, "OMP_NUM_THREADS": "1"}
    out = _run("quickstart_torch.py", "--device", "cpu", env=env).strip().splitlines()
    # the direct call, in a process of the same environment
    code = ("import importlib.util, json; spec = importlib.util.spec_from_file_location('q', "
            "'examples/quickstart_torch.py'); mod = importlib.util.module_from_spec(spec); "
            "spec.loader.exec_module(mod); print('JSON' + json.dumps(mod.train('cpu')))")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=REPO, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    losses = json.loads(res.stdout.split("JSON", 1)[1])
    assert len(losses) == 40
    printed = [line.split("loss=")[1].split()[0] for line in out if line.startswith("step")]
    assert printed == [f"{x:.6f}" for x in losses[::5]]
    assert out[-1].startswith(f"done: loss {losses[0]:.6f} -> {losses[-1]:.6f}")
    assert losses[0] - losses[-1] > 0.5


def test_reshard_demo_example_plan_lines_equal_the_jax_demo():
    ours = _run("reshard_demo_torch.py", "--device", "cpu").splitlines()
    theirs = _run("reshard_demo.py").splitlines()
    plan_lines = lambda lines: [x for x in lines if not x.lstrip().startswith("executed")]  # noqa: E731
    assert plan_lines(ours) == plan_lines(theirs)
    executed = [x for x in ours if x.lstrip().startswith("executed")]
    assert len(executed) == 2 and all(x.endswith("bit-exact") for x in executed)


def test_fleet_example_all_sim_equals_the_jax_example():
    ours = _run("fleet_train_torch.py", "--all-sim")
    theirs = _run("fleet_train.py", "--all-sim")
    assert ours == theirs
    assert "goodput" in ours and len(ours.strip().splitlines()) == 3


def test_fleet_example_live_job_on_cpu():
    out = _run("fleet_train_torch.py", "--device", "cpu")
    live = next(x for x in out.splitlines() if x.strip().startswith("live    goodput"))
    assert "outcomes=['committed', 'committed', 'committed']" in live
    assert "plan[live]: t=0s→8dev, t=16s→4dev, t=24s→8dev" in out
