"""Public model API: init / forward / loss / prefill / decode.

The counterpart of ``repro/models/model.py`` for decoder-only dense models;
other families raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import kvcache
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.utils.pytree import tree_map_with_path, tree_paths

# leaves read in fp32 whatever the activation dtype (norm scales)
_FP32_LEAVES = ("scale", "q_norm", "k_norm")


def _dtype(name: str) -> torch.dtype:
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dtype


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, refusing a CUDA request without a card:
    nothing carries on quietly on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available "
            "(torch.cuda.is_available() is False); pass device='cpu' to run on the CPU"
        )
    return dev


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None, device="cuda") -> dict:
    """Parameters in ``cfg.param_dtype``, drawn from one seeded generator on
    ``device`` (seed 0 when none is given) with the JAX package's
    distributions and paths. ``device="meta"`` gives shapes only."""
    dev = resolve_device(device)
    if generator is None and dev.type != "meta":
        generator = torch.Generator(device=dev).manual_seed(0)
    T.check_ported(cfg)
    pdt = _dtype(cfg.param_dtype)
    params = {
        "embed": L.embed_init(generator, cfg, pdt, dev),
        "blocks": T.stack_init(generator, cfg, pdt, dev),
        "final_norm": L.rmsnorm_init(cfg.d_model, pdt, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.lm_head_init(generator, cfg, pdt, dev)
    return params


def abstract_params(cfg: ModelConfig) -> dict:
    """The param tree on the meta device: shapes and dtypes, no storage
    (the counterpart of the JAX package's ``eval_shape`` tree)."""
    return init_params(cfg, device="meta")


def param_logical_axes(cfg: ModelConfig) -> dict:
    """Logical-axis tuples mirroring the param tree (tuples are leaves)."""
    axes = {
        "embed": L.EMBED_AXES,
        "blocks": T.stack_axes(cfg),
        "final_norm": L.RMSNORM_AXES,
    }
    if not cfg.tie_embeddings:
        axes["lm_head"] = L.LM_HEAD_AXES
    return axes


def param_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """``{a/b/c path: shape}`` of :func:`init_params`, without allocating."""
    return {p: tuple(x.shape) for p, x in tree_paths(abstract_params(cfg)).items()}


def analytic_param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    """Parameter count of the built model. The ported families have no
    experts, so every parameter is active and ``active_only`` changes
    nothing."""
    return sum(math.prod(shape) for shape in param_shapes(cfg).values())


def cast_params(params: dict, dtype) -> dict:
    """A copy of ``params`` with every matrix and bias cast to ``dtype``
    once, for serving. The JAX model casts each fp32 parameter at every use;
    a cast is deterministic, so the pre-cast values are bit-identical to
    those casts and the model computes the same thing. Norm scales stay
    fp32, because the model reads them in fp32."""
    dtype = _dtype(dtype) if isinstance(dtype, str) else dtype
    return tree_map_with_path(
        lambda path, x: x if path.rsplit("/", 1)[-1] in _FP32_LEAVES else x.to(dtype),
        params,
    )


# ---------------------------------------------------------------------------
# Forward / loss (training)
# ---------------------------------------------------------------------------


def forward(cfg: ModelConfig, params: dict, batch: dict, remat: str = "full"):
    """Full-sequence forward. Returns (logits (b, s, V), moe aux loss).

    ``batch = {"tokens": (b, s) integer tensor}``. Attention goes through
    ``ops.flash_attention``: on the card the CUDA kernel and its backward
    kernel, on the CPU the plain version under autograd."""
    T.check_ported(cfg)
    adt = _dtype(cfg.dtype)
    tokens = batch["tokens"]
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device).expand(b, s)
    # the JAX package pins the embedding output's and the logits' sharding
    # (shard_hints.constrain); one process has nothing to pin
    x = L.embed_apply(params["embed"], tokens, adt)
    x, aux = T.stack_forward(params["blocks"], cfg, x, positions, causal=True, remat=remat)
    x = L.rmsnorm_apply(params["final_norm"], x)
    logits = L.lm_head_apply(params.get("lm_head"), params["embed"], x)
    return logits, aux


def loss_fn(cfg: ModelConfig, params: dict, batch: dict, remat: str = "full", aux_weight: float = 0.01):
    """Next-token cross-entropy in float32 over ``logits[:, :-1]``, plus
    ``aux_weight`` times the MoE aux loss. Returns (loss, {"nll", "moe_aux"})."""
    logits, aux = forward(cfg, params, batch, remat=remat)
    tokens = batch["tokens"]
    logits = logits[:, :-1].to(torch.float32)
    targets = tokens[:, 1:].long()
    logz = torch.logsumexp(logits, dim=-1)
    tgt_logit = torch.take_along_dim(logits, targets[..., None], dim=-1)[..., 0]
    nll = (logz - tgt_logit).mean()
    loss = nll + aux_weight * aux
    return loss, {"nll": nll, "moe_aux": aux}


# ---------------------------------------------------------------------------
# Prefill / decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=torch.bfloat16, device="cuda"):
    return kvcache.init_cache(cfg, batch, max_seq, dtype, resolve_device(device))


def prefill(cfg: ModelConfig, params: dict, batch: dict, cache_dtype=torch.bfloat16, max_seq: int = 0):
    """Process the prompt; returns (last_logits (b,1,V), cache, cross_kv).

    ``batch = {"tokens": (b, s) integer tensor}``. ``max_seq`` is the total
    decode horizon: the cache is sized for it. ``cross_kv`` is None (enc-dec
    models are not ported yet).
    """
    T.check_ported(cfg)
    adt = _dtype(cfg.dtype)
    tokens = batch["tokens"]
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device).expand(b, s)
    # the JAX package pins the embedding output's sharding here
    # (shard_hints.constrain); one process has nothing to pin
    x = L.embed_apply(params["embed"], tokens, adt)
    x, collected = T.stack_prefill(params["blocks"], cfg, x, positions)
    x = L.rmsnorm_apply(params["final_norm"], x[:, -1:])
    logits = L.lm_head_apply(params.get("lm_head"), params["embed"], x)
    cache = kvcache.cache_from_prefill(cfg, collected, cache_dtype, max_seq=max_seq)
    return logits, cache, None


def decode_step(cfg: ModelConfig, params: dict, cache: dict, tokens: torch.Tensor, pos: int):
    """One serving step: returns (logits (b,1,V), cache). ``tokens`` is
    (b, 1); ``pos`` the absolute position of the new token. The cache is
    updated in place and returned."""
    adt = _dtype(cfg.dtype)
    x = L.embed_apply(params["embed"], tokens, adt)
    x, cache = T.stack_decode(params["blocks"], cfg, x, cache, int(pos))
    x = L.rmsnorm_apply(params["final_norm"], x)
    logits = L.lm_head_apply(params.get("lm_head"), params["embed"], x)
    return logits, cache
