"""Batched decode serving launcher (prefill + autoregressive decode loop).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        --batch 8 --prompt-len 512 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b \\
        --reduced --device cpu --batch 2 --prompt-len 32 --gen 4

Runs on the GPU unless ``--device cpu`` is given; a CUDA request without a
card exits with an error. Thin front-end over
:func:`repro_torch.serve.driver.serve_once`.
"""

from __future__ import annotations

import argparse


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    from repro_torch.configs import get_config
    from repro_torch.serve.driver import serve_once

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    out = serve_once(
        cfg,
        batch=args.batch,
        prompt_len=args.prompt_len,
        gen=args.gen,
        temperature=args.temperature,
        seed=args.seed,
        device=args.device,
    )
    toks = out["tokens"]
    print(f"[prefill] {args.batch}x{args.prompt_len} tokens in {out['prefill_s']:.3f}s")
    print(f"[decode] {args.gen} steps x batch {args.batch} in {out['decode_s']:.3f}s "
          f"({args.gen * args.batch / out['decode_s']:.1f} tok/s)")
    print("[sample] first request tokens:", [int(t) for t in toks[0][:12]])


if __name__ == "__main__":
    main()
