"""Mamba-2 SSD (state-space duality) mixer.

The port of ``repro/models/ssm.py``, function for function. Used by
``mamba2-2.7b`` (every layer). Prefill and the training forward use the
chunked SSD scan (``ops.ssd_scan``: on the card the intra-chunk CUDA
kernel, on the CPU the plain version); decode uses the O(1) recurrent
update in plain torch, as the JAX package leaves it to XLA.

``A_log``, ``dt_bias``, ``D``, ``conv_w``, ``conv_b`` and ``norm_scale``
are read in float32 whatever the activation dtype, as in the JAX mixer;
``model.cast_params`` keeps them in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import _dense_init

SSM_HEAD_DIM = 64
CONV_WIDTH = 4

SSM_AXES = {
    "wz": ("embed", "inner"),
    "wx": ("embed", "inner"),
    "wB": ("embed", "state"),
    "wC": ("embed", "state"),
    "wdt": ("embed", "ssm_heads"),
    "dt_bias": ("ssm_heads",),
    "A_log": ("ssm_heads",),
    "D": ("ssm_heads",),
    "conv_w": ("conv_k", "inner"),
    "conv_b": ("inner",),
    "norm_scale": ("inner",),
    "wo": ("inner", "embed"),
}


def ssm_dims(cfg: ModelConfig) -> tuple[int, int, int, int]:
    """(d_inner, nheads, d_state, conv_channels)."""
    d_inner = cfg.ssm_expand * cfg.d_model
    nheads = d_inner // SSM_HEAD_DIM
    d_state = cfg.ssm_state
    conv_ch = d_inner + 2 * d_state
    return d_inner, nheads, d_state, conv_ch


def ssm_init(gen, cfg: ModelConfig, dtype, device, lead=()) -> dict:
    """The JAX package's distributions: dense weights ``N(0, 1/fan_in)``,
    ``dt_bias = log(expm1(0.01))``, ``A_log = log(U(1, 16))`` (drawn in
    float32), ``D`` and ``norm_scale`` ones, ``conv_b`` zeros."""
    d = cfg.d_model
    i, h, n, conv_ch = ssm_dims(cfg)
    meta = torch.device(device).type == "meta"
    a = torch.rand((*lead, h), generator=None if meta else gen, dtype=torch.float32, device=device)
    dt_bias = torch.log(torch.expm1(torch.full((*lead, h), 0.01, dtype=torch.float32, device=device)))
    return {
        "wz": _dense_init(gen, (d, i), dtype, device, lead),
        "wx": _dense_init(gen, (d, i), dtype, device, lead),
        "wB": _dense_init(gen, (d, n), dtype, device, lead),
        "wC": _dense_init(gen, (d, n), dtype, device, lead),
        "wdt": _dense_init(gen, (d, h), dtype, device, lead),
        "dt_bias": dt_bias.to(dtype),
        "A_log": torch.log(1.0 + 15.0 * a).to(dtype),
        "D": torch.ones((*lead, h), dtype=dtype, device=device),
        "conv_w": _dense_init(gen, (CONV_WIDTH, conv_ch), dtype, device, lead),
        "conv_b": torch.zeros((*lead, conv_ch), dtype=dtype, device=device),
        "norm_scale": torch.ones((*lead, i), dtype=dtype, device=device),
        "wo": _dense_init(gen, (i, d), dtype, device, lead),
    }


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, xbc: (b, s, c), w: (K, c); float32 sums, cast
    back to xbc's dtype."""
    K = w.shape[0]
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    out = torch.zeros(xbc.shape, dtype=torch.float32, device=xbc.device)
    for t in range(K):
        out = out + pad[:, t : t + xbc.shape[1], :].float() * w[t].float()
    return (out + b.float()).to(xbc.dtype)


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    yf = (y * F.silu(z.float())).float()
    var = yf.square().mean(dim=-1, keepdim=True)
    return (yf * torch.rsqrt(var + eps) * scale.float()).to(y.dtype)


def _pre_ssd(params: dict, cfg: ModelConfig, x: torch.Tensor):
    """Shared projections for forward/decode. x: (b, s, d)."""
    z = x @ params["wz"].to(x.dtype)
    xi = x @ params["wx"].to(x.dtype)
    Bssm = x @ params["wB"].to(x.dtype)
    Cssm = x @ params["wC"].to(x.dtype)
    dt_raw = x @ params["wdt"].to(x.dtype)
    xbc = torch.cat([xi, Bssm, Cssm], dim=-1)
    return z, xbc, dt_raw


def _post_conv_split(cfg: ModelConfig, xbc: torch.Tensor):
    i, h, n, _ = ssm_dims(cfg)
    xbc = F.silu(xbc.float()).to(xbc.dtype)
    xi, Bssm, Cssm = torch.split(xbc, [i, n, n], dim=-1)
    return xi, Bssm, Cssm


def ssm_forward(
    params: dict,
    cfg: ModelConfig,
    x: torch.Tensor,
    return_state: bool = False,
    init_state: dict | None = None,
):
    """Full-sequence SSD forward. x: (b, s, d) -> (b, s, d).

    ``init_state`` ({"ssd", "conv"}) continues from a previous chunk: the
    conv uses the cached raw history instead of zero padding and the SSD
    recurrence starts from the carried state. With ``return_state`` also
    returns the state after the last step (``{"ssd": (b,h,p,n), "conv":
    (b, CONV_WIDTH-1, conv_ch)}``, float32), the decode cache."""
    b, s, d = x.shape
    i, h, n, _ = ssm_dims(cfg)
    p = SSM_HEAD_DIM
    z, xbc_raw, dt_raw = _pre_ssd(params, cfg, x)
    if init_state is not None:
        full = torch.cat([init_state["conv"].to(xbc_raw.dtype), xbc_raw], dim=1)
        xbc = _causal_conv(full, params["conv_w"], params["conv_b"])[:, CONV_WIDTH - 1 :]
        xbc_hist_src = full
    else:
        xbc = _causal_conv(xbc_raw, params["conv_w"], params["conv_b"])
        xbc_hist_src = xbc_raw
    xi, Bssm, Cssm = _post_conv_split(cfg, xbc)

    dt = F.softplus(dt_raw.float() + params["dt_bias"].float())  # (b, s, h)
    A = -torch.exp(params["A_log"].float())  # (h,)
    xh = xi.reshape(b, s, h, p)
    y, final_state = ops.ssd_scan(
        xh,
        dt,
        A,
        Bssm.float(),
        Cssm.float(),
        cfg.ssm_chunk,
        init_state=init_state["ssd"].float() if init_state is not None else None,
    )
    y = y + xh.float() * params["D"].float()[None, None, :, None]
    y = y.reshape(b, s, i).to(x.dtype)
    y = _gated_norm(y, z, params["norm_scale"])
    out = y @ params["wo"].to(x.dtype)
    if return_state:
        state = {
            "ssd": final_state,
            "conv": xbc_hist_src[:, -(CONV_WIDTH - 1) :, :].float(),
        }
        return out, state
    return out


# ---------------------------------------------------------------------------
# Decode (recurrent, O(1) per token)
# ---------------------------------------------------------------------------


def ssm_init_state(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    """Zero ssd and conv state for ``batch`` sequences, in ``dtype`` on
    ``device`` (no default: a serving cache belongs on the world's device)."""
    i, h, n, conv_ch = ssm_dims(cfg)
    return {
        "ssd": torch.zeros((batch, h, SSM_HEAD_DIM, n), dtype=dtype, device=device),
        "conv": torch.zeros((batch, CONV_WIDTH - 1, conv_ch), dtype=dtype, device=device),
    }


def ssm_decode(params: dict, cfg: ModelConfig, x: torch.Tensor, state: dict):
    """x: (b, 1, d). Returns (y, new_state); ``state`` is not modified."""
    b = x.shape[0]
    i, h, n, conv_ch = ssm_dims(cfg)
    p = SSM_HEAD_DIM
    z, xbc, dt_raw = _pre_ssd(params, cfg, x)  # (b, 1, *)
    # conv with the cached history
    hist = torch.cat([state["conv"], xbc.to(state["conv"].dtype)], dim=1)
    w = params["conv_w"].float()
    conv_out = (hist.float() * w[None]).sum(dim=1, keepdim=True) + params["conv_b"].float()
    xi, Bssm, Cssm = _post_conv_split(cfg, conv_out.to(x.dtype))
    new_conv = hist[:, 1:, :]

    dt = F.softplus(dt_raw[:, 0].float() + params["dt_bias"].float())  # (b, h)
    A = -torch.exp(params["A_log"].float())
    decay = torch.exp(dt * A[None, :])  # (b, h)
    xh = xi[:, 0].reshape(b, h, p).float()
    Bv = Bssm[:, 0].float()  # (b, n)
    Cv = Cssm[:, 0].float()
    ssd = state["ssd"].float()
    ssd = decay[:, :, None, None] * ssd + (dt[:, :, None, None] * xh[..., None]) * Bv[:, None, None, :]
    y = torch.einsum("bhpn,bn->bhp", ssd, Cv) + xh * params["D"].float()[None, :, None]
    y = y.reshape(b, 1, i).to(x.dtype)
    y = _gated_norm(y, z, params["norm_scale"])
    out = y @ params["wo"].to(x.dtype)
    return out, {"ssd": ssd.to(state["ssd"].dtype), "conv": new_conv}
