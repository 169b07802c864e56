"""The port's serving example on the CPU: ``examples/serve_decode_torch.py
--device cpu`` serves reduced qwen3, mixtral and mamba2 through
``serve_once``, and the tokens it prints are those of the same call made
here."""

from __future__ import annotations

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
