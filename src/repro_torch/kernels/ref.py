"""Plain-PyTorch versions of the kernels in this package.

Each one is written out as its counterpart in ``repro/kernels/ref.py``:
fp32 scores, a ``-1e30`` mask value, softmax, cast back to the input dtype.
They are the CPU path of ``ops.py`` and what the CUDA kernels are held
against on the card.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(
    q: torch.Tensor,  # (b, s, h, d)
    k: torch.Tensor,  # (b, t, kh, d)
    v: torch.Tensor,  # (b, t, kh, d)
    causal: bool = True,
    window: int = 0,
    scale: float | None = None,
) -> torch.Tensor:
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    rep = h // kh
    if scale is None:
        scale = d**-0.5
    kf = torch.repeat_interleave(k.float(), rep, dim=2)
    vf = torch.repeat_interleave(v.float(), rep, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q.float() * scale, kf)
    qpos = torch.arange(s, device=q.device)[:, None] + (t - s)  # right-aligned when t != s
    kpos = torch.arange(t, device=q.device)[None, :]
    if causal:
        mask = kpos <= qpos
    else:
        mask = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if window > 0:
        mask &= kpos > qpos - window
    scores = torch.where(mask[None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", probs, vf)
    return out.to(q.dtype)


def decode_attention_ref(
    q: torch.Tensor,  # (b, 1, h, d)
    k: torch.Tensor,  # (b, T, kh, d)
    v: torch.Tensor,
    mask: torch.Tensor,  # broadcastable to (b, 1, 1, T)
    scale: float,
) -> torch.Tensor:
    h, kh = q.shape[2], k.shape[2]
    rep = h // kh
    kf = torch.repeat_interleave(k.float(), rep, dim=2)
    vf = torch.repeat_interleave(v.float(), rep, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q.float() * scale, kf)
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", probs, vf)
    return out.to(q.dtype)
