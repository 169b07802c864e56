"""Quickstart on the PyTorch port: train a tiny LM for 40 steps, watch the
loss drop.

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

The torch version of ``examples/quickstart.py``: reduced qwen3, one world
on one device, AdamW. It runs on the card (attention through the flash
kernels) unless ``--device cpu`` is given; a CUDA request without a card
raises. It exits non-zero unless the loss drops by more than 0.5 nats.
"""

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.distribution.step import init_train_state, make_train_step  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402

STEPS, SEQ, BATCH = 40, 64, 8
MIN_DROP = 0.5  # nats


def train(device: str) -> list[float]:
    """The 40 steps' losses."""
    cfg = get_config("qwen3-1.7b").reduced()
    params, opt_state = init_train_state(cfg, seed=0, device=device)
    step = make_train_step(cfg, AdamWConfig(learning_rate=3e-3, warmup_steps=10, total_steps=STEPS))
    data = SyntheticLM(cfg.vocab_size, seq_len=SEQ, global_batch=BATCH, seed=0)
    losses = []
    for i in range(STEPS):
        batch = {"tokens": torch.from_numpy(data.global_batch_at(i)).to(device=device, dtype=torch.long)}
        params, opt_state, metrics = step(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        if i % 5 == 0:
            print(f"step {i:3d}  loss={losses[-1]:.6f}  lr={float(metrics['lr']):.2e}")
    return losses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    losses = train(args.device)
    drop = losses[0] - losses[-1]
    print(f"done: loss {losses[0]:.6f} -> {losses[-1]:.6f}, dropped by {drop:.4f} nats (want > {MIN_DROP})")
    if not drop > MIN_DROP:
        sys.exit(f"the loss dropped by {drop:.4f} nats, not more than {MIN_DROP}")


if __name__ == "__main__":
    main()
