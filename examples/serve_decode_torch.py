"""Batched serving on the PyTorch port: prefill a prompt batch and decode
autoregressively with the KV and SSD caches, for three architecture
families (attention, MoE, SSM) at their reduced sizes, through
``repro_torch.serve.driver.serve_once``.

    PYTHONPATH=src python examples/serve_decode_torch.py
    PYTHONPATH=src python examples/serve_decode_torch.py --device cpu

The torch version of ``examples/serve_decode.py``. It runs on the card
unless ``--device cpu`` is given; a CUDA request without a card raises.
"""

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.serve.driver import serve_once  # noqa: E402

ARCHS = ("qwen3-1.7b", "mixtral-8x7b", "mamba2-2.7b")


def serve(arch: str, device: str, batch_size: int = 2, prompt_len: int = 32, gen: int = 8) -> dict:
    cfg = get_config(arch).reduced()
    out = serve_once(cfg, batch=batch_size, prompt_len=prompt_len, gen=gen, device=device)
    toks = out["tokens"]
    dt = out["prefill_s"] + out["decode_s"]
    print(f"{arch:26s} [{cfg.family:6s}] generated {toks.shape[1]} tokens/request "
          f"in {dt:.2f}s -> {[int(t) for t in toks[0][:8]]}", flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    for arch in ARCHS:
        serve(arch, args.device)


if __name__ == "__main__":
    main()
