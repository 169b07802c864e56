"""Public model API: init / forward / loss / prefill / decode.

The counterpart of ``repro/models/model.py`` for decoder-only models with
attention or SSM (Mamba-2) mixers and dense, MoE or no MLPs, and for
enc-dec models (an encoder over precomputed frame embeddings, the audio
frontend's stub, and a decoder with cross attention).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import kvcache
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.utils.pytree import axes_paths, tree_map_with_path, tree_paths

# leaves read in fp32 whatever the activation dtype: norm scales, and the
# SSM mixer's decay, bias, skip, conv and gated-norm parameters
_FP32_LEAVES = ("scale", "q_norm", "k_norm", "A_log", "dt_bias", "D", "conv_w", "conv_b", "norm_scale")


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


def init_params(
    cfg: ModelConfig, generator: torch.Generator | None = None, device="cuda", served_dtype=None
) -> dict:
    """Parameters in ``cfg.param_dtype``, drawn from one seeded generator on
    ``device`` (seed 0 when none is given) with the JAX package's
    distributions and paths. ``device="meta"`` gives shapes only.

    ``served_dtype``, given, returns the bits of ``cast_params(init_params(
    ...), served_dtype)`` but casts each part of a block, and each MoE
    expert matrix, as soon as it is drawn: the peak is the served tree plus
    one float32 part, not the whole float32 tree beside it."""
    dev = resolve_device(device)
    if generator is None and dev.type != "meta":
        generator = torch.Generator(device=dev).manual_seed(0)
    pdt = _dtype(cfg.param_dtype)
    cast = (lambda tree: cast_params(tree, served_dtype)) if served_dtype is not None else (lambda tree: tree)
    params = {"embed": cast(L.embed_init(generator, cfg, pdt, dev))}
    if cfg.family == "encdec":
        params["encoder"] = {
            "blocks": T.stack_init(generator, _encoder_cfg(cfg), pdt, dev, cast),
            "final_norm": cast(L.rmsnorm_init(cfg.d_model, pdt, dev)),
        }
    params["blocks"] = T.stack_init(generator, cfg, pdt, dev, cast, cross=cfg.family == "encdec")
    params["final_norm"] = cast(L.rmsnorm_init(cfg.d_model, pdt, dev))
    if not cfg.tie_embeddings:
        params["lm_head"] = cast(L.lm_head_init(generator, cfg, pdt, dev))
    return params


def _encoder_cfg(cfg: ModelConfig) -> ModelConfig:
    """The encoder's stack of an enc-dec ``cfg``: dense attention blocks,
    ``encoder_layers`` of them."""
    return dataclasses.replace(
        cfg, family="dense", num_layers=cfg.encoder_layers, num_experts=0, attn_period=0, frontend=None
    )


def abstract_params(cfg: ModelConfig) -> dict:
    """The param tree on the meta device: shapes and dtypes, no storage
    (the counterpart of the JAX package's ``eval_shape`` tree)."""
    return init_params(cfg, device="meta")


def param_logical_axes(cfg: ModelConfig) -> dict:
    """Logical-axis tuples mirroring the param tree (tuples are leaves)."""
    axes = {
        "embed": L.EMBED_AXES,
        "blocks": T.stack_axes(cfg, cross=cfg.family == "encdec"),
        "final_norm": L.RMSNORM_AXES,
    }
    if cfg.family == "encdec":
        axes["encoder"] = {"blocks": T.stack_axes(_encoder_cfg(cfg)), "final_norm": L.RMSNORM_AXES}
    if not cfg.tie_embeddings:
        axes["lm_head"] = L.LM_HEAD_AXES
    return axes


def param_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """``{a/b/c path: shape}`` of :func:`init_params`, without allocating."""
    return {p: tuple(x.shape) for p, x in tree_paths(abstract_params(cfg)).items()}


def analytic_param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    """Parameter count of the built model. ``active_only`` counts a leaf
    with an ``"expert"`` axis at ``experts_per_token / num_experts`` of its
    size (floored per leaf, as the JAX package counts it)."""
    axes = axes_paths(param_logical_axes(cfg))
    total = 0
    for path, shape in param_shapes(cfg).items():
        n = math.prod(shape)
        if active_only and cfg.num_experts > 0 and "expert" in axes[path]:
            n = n * cfg.experts_per_token // cfg.num_experts
        total += n
    return total


def cast_params(params: dict, dtype) -> dict:
    """A copy of ``params`` with every matrix and bias cast to ``dtype``
    once, for serving. The JAX model casts each fp32 parameter at every use;
    a cast is deterministic, so the pre-cast values are bit-identical to
    those casts and the model computes the same thing. The leaves the model
    reads in fp32 stay fp32 (:data:`_FP32_LEAVES`: norm scales and the SSM
    mixer's ``A_log``, ``dt_bias``, ``D``, ``conv_w``, ``conv_b``,
    ``norm_scale``)."""
    dtype = _dtype(dtype) if isinstance(dtype, str) else dtype
    return tree_map_with_path(
        lambda path, x: x if path.rsplit("/", 1)[-1] in _FP32_LEAVES else x.to(dtype),
        params,
    )


# ---------------------------------------------------------------------------
# Forward / loss (training)
# ---------------------------------------------------------------------------


def encode(cfg: ModelConfig, params: dict, frames: torch.Tensor, remat: str = "full") -> torch.Tensor:
    """The encoder of an enc-dec model over ``frames`` (b, s_enc, d_model),
    cast to ``cfg.dtype``: non-causal self-attention through
    ``ops.flash_attention`` at positions ``0..s_enc-1``, then the encoder's
    final norm."""
    b, s, _ = frames.shape
    positions = torch.arange(s, dtype=torch.int32, device=frames.device).expand(b, s)
    x, _ = T.stack_forward(
        params["encoder"]["blocks"], _encoder_cfg(cfg), frames.to(_dtype(cfg.dtype)), positions,
        causal=False, remat=remat,
    )
    return L.rmsnorm_apply(params["encoder"]["final_norm"], x)


def forward(cfg: ModelConfig, params: dict, batch: dict, remat: str = "full"):
    """Full-sequence forward. Returns (logits (b, s, V), moe aux loss).

    ``batch = {"tokens": (b, s) integer tensor}``, plus ``"frames"`` (b,
    s_enc, d_model) for an enc-dec model. Attention goes through
    ``ops.flash_attention``: on the card the CUDA kernel and its backward
    kernel, on the CPU the plain version under autograd. The SSM mixer's
    scan goes through ``ops.ssd_scan``: on the card the intra-chunk kernel
    and its backward kernel, on the CPU the plain version under autograd."""
    adt = _dtype(cfg.dtype)
    tokens = batch["tokens"]
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device).expand(b, s)
    # the JAX package pins the embedding output's and the logits' sharding
    # (shard_hints.constrain); one process has nothing to pin
    enc_out = encode(cfg, params, batch["frames"], remat=remat) if cfg.family == "encdec" else None
    x = L.embed_apply(params["embed"], tokens, adt)
    x, aux = T.stack_forward(params["blocks"], cfg, x, positions, causal=True, enc_out=enc_out, remat=remat)
    x = L.rmsnorm_apply(params["final_norm"], x)
    logits = L.lm_head_apply(params.get("lm_head"), params["embed"], x)
    return logits, aux


def next_token_nll(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy in float32 over ``logits[:, :-1]``."""
    logits = logits[:, :-1].to(torch.float32)
    targets = tokens[:, 1:].long()
    logz = torch.logsumexp(logits, dim=-1)
    tgt_logit = torch.take_along_dim(logits, targets[..., None], dim=-1)[..., 0]
    return (logz - tgt_logit).mean()


def rank_embed(cfg: ModelConfig, params: dict, tokens: torch.Tensor, groups) -> torch.Tensor:
    """The vocab-parallel embedding of ``tokens`` on one rank's rows of the
    table (``distribution/tp.py::embed``), in ``cfg.dtype``."""
    from repro_torch.core.resource_view import split_bounds
    from repro_torch.distribution import tp as TP

    lo = split_bounds(cfg.vocab_size, groups.tp, groups.tp_rank)[0]
    return TP.embed(params["embed"]["tok"], tokens, lo, _dtype(cfg.dtype), groups)


def rank_nll(cfg: ModelConfig, params: dict, x: torch.Tensor, tokens: torch.Tensor, groups) -> torch.Tensor:
    """The final norm on the gathered scale and the vocab-parallel
    cross-entropy of the stack's output ``x`` over this rank's vocabulary
    rows of the head, against the next tokens of ``tokens``; the full
    logits are never formed."""
    from repro_torch.core.resource_view import split_bounds
    from repro_torch.distribution import tp as TP

    lo = split_bounds(cfg.vocab_size, groups.tp, groups.tp_rank)[0]
    h = L.rmsnorm_apply(params["final_norm"], TP.copy_to(x, groups), groups=groups)[:, :-1]
    w = params["embed"]["tok"].T if cfg.tie_embeddings else params["lm_head"]["w"]
    return TP.nll((h @ w.to(h.dtype)).to(torch.float32), tokens[:, 1:].long(), lo, groups)


def positions_of(tokens: torch.Tensor) -> torch.Tensor:
    """Positions 0..s-1 of each row of ``tokens`` (b, s), int32."""
    b, s = tokens.shape
    return torch.arange(s, dtype=torch.int32, device=tokens.device).expand(b, s)


def _rank_loss(cfg: ModelConfig, params: dict, batch: dict, remat: str, groups):
    """:func:`loss_fn` on one rank's shards of a per-rank world without
    pipeline stages (a decoder of attention blocks): the vocab-parallel
    embedding, the stack's tp and ep regions, and :func:`rank_nll`. The
    loss is this rank's dp rows' mean."""
    tokens = batch["tokens"]
    x = rank_embed(cfg, params, tokens, groups)
    x, aux = T.stack_forward(params["blocks"], cfg, x, positions_of(tokens), causal=True, remat=remat,
                             groups=groups)
    return rank_nll(cfg, params, x, tokens, groups), aux


def loss_fn(cfg: ModelConfig, params: dict, batch: dict, remat: str = "full", aux_weight: float = 0.01,
            groups=None):
    """Next-token cross-entropy in float32 over ``logits[:, :-1]``, plus
    ``aux_weight`` times the MoE aux loss. Returns (loss, {"nll", "moe_aux"}).
    ``groups`` (``distribution/groups.py``) computes it on one rank's shards
    of a per-rank world (:func:`_rank_loss`)."""
    if groups is not None:
        nll, aux = _rank_loss(cfg, params, batch, remat, groups)
        return nll + aux_weight * aux, {"nll": nll, "moe_aux": aux}
    logits, aux = forward(cfg, params, batch, remat=remat)
    nll = next_token_nll(logits, batch["tokens"])
    loss = nll + aux_weight * aux
    return loss, {"nll": nll, "moe_aux": aux}


# ---------------------------------------------------------------------------
# Prefill / decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=torch.bfloat16, device="cuda"):
    return kvcache.init_cache(cfg, batch, max_seq, dtype, resolve_device(device))


def abstract_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=torch.bfloat16) -> dict:
    """The cache tree on the meta device: shapes and dtypes, no storage
    (the counterpart of the JAX package's ``eval_shape`` cache)."""
    return kvcache.init_cache(cfg, batch, max_seq, dtype, "meta")


def prefill(cfg: ModelConfig, params: dict, batch: dict, cache_dtype=torch.bfloat16, max_seq: int = 0):
    """Process the prompt; returns (last_logits (b,1,V), cache, cross_kv).

    ``batch = {"tokens": (b, s) integer tensor}``, plus ``"frames"`` for an
    enc-dec model. ``max_seq`` is the total decode horizon: the cache is
    sized for it. ``cross_kv`` is the decoder's cross-attention KV of an
    enc-dec model (``kvcache.init_cross_kv``'s layout) in ``cache_dtype``,
    as the serving specs hold it (the JAX package returns it in
    ``cfg.dtype``), else None.
    """
    adt = _dtype(cfg.dtype)
    tokens = batch["tokens"]
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device).expand(b, s)
    # the JAX package pins the embedding output's sharding here
    # (shard_hints.constrain); one process has nothing to pin
    enc_out = cross_kv = None
    if cfg.family == "encdec":
        enc_out = encode(cfg, params, batch["frames"])
        cross_kv = _build_cross_kv(cfg, params, enc_out, cache_dtype)
    x = L.embed_apply(params["embed"], tokens, adt)
    x, collected = T.stack_prefill(params["blocks"], cfg, x, positions, enc_out=enc_out)
    x = L.rmsnorm_apply(params["final_norm"], x[:, -1:])
    logits = L.lm_head_apply(params.get("lm_head"), params["embed"], x)
    cache = kvcache.cache_from_prefill(cfg, collected, cache_dtype, max_seq=max_seq)
    return logits, cache, cross_kv


def prefill_chunked(
    cfg: ModelConfig, params: dict, batch: dict, chunk_len: int, max_seq: int = 0, cache_dtype=torch.bfloat16
):
    """Chunked prefill of a decoder-only model: the prompt ``chunk_len``
    tokens at a time against the growing KV and SSD cache
    (``transformer.stack_chunk``), which bounds the activations to
    O(chunk x context) instead of whole prefill's O(s^2) scores. The
    prompt length must be a multiple of ``chunk_len``; the cache is sized
    for a horizon of ``max(max_seq, s)``, in ``cache_dtype`` (the port's
    default, as :func:`prefill`; the JAX package defaults to float32).
    Returns (last_logits (b,1,V), cache), the contract of :func:`prefill`
    without the cross KV."""
    if cfg.family == "encdec":
        raise ValueError(f"{cfg.name}: chunked prefill is decoder-only (an enc-dec model has cross attention)")
    tokens = batch["tokens"]
    b, s = tokens.shape
    if chunk_len <= 0 or s % chunk_len:
        raise ValueError(f"prompt length {s} is not a multiple of chunk_len={chunk_len}")
    adt = _dtype(cfg.dtype)
    cache = kvcache.init_cache(cfg, b, max(max_seq, s), cache_dtype, tokens.device)
    for pos0 in range(0, s, chunk_len):
        x = L.embed_apply(params["embed"], tokens[:, pos0 : pos0 + chunk_len], adt)
        x, cache = T.stack_chunk(params["blocks"], cfg, x, cache, pos0)
    h = L.rmsnorm_apply(params["final_norm"], x[:, -1:])
    return L.lm_head_apply(params.get("lm_head"), params["embed"], h), cache


def _build_cross_kv(cfg: ModelConfig, params: dict, enc_out: torch.Tensor, dtype) -> dict:
    """Each decoder layer's cross-attention (k, v) of ``enc_out``, stacked
    over periods per block position, cast to ``dtype``."""
    from repro_torch.models.attention import cross_attn_kv

    out = {}
    for j in range(len(T.block_program(cfg))):
        cross = params["blocks"][f"pos{j}"]["cross"]
        kv = [cross_attn_kv(T._period(cross, i), cfg, enc_out) for i in range(T.n_periods(cfg))]
        out[f"pos{j}"] = {
            "k": torch.stack([k for k, _ in kv]).to(dtype),
            "v": torch.stack([v for _, v in kv]).to(dtype),
        }
    return out


def decode_step(cfg: ModelConfig, params: dict, cache: dict, tokens: torch.Tensor, pos: int, cross_kv=None):
    """One serving step: returns (logits (b,1,V), cache). ``tokens`` is
    (b, 1); ``pos`` the absolute position of the new token; ``cross_kv``
    the prefill's cross-attention KV (enc-dec). The cache is updated in
    place and returned."""
    adt = _dtype(cfg.dtype)
    x = L.embed_apply(params["embed"], tokens, adt)
    x, cache = T.stack_decode(params["blocks"], cfg, x, cache, int(pos), cross_kv)
    x = L.rmsnorm_apply(params["final_norm"], x)
    logits = L.lm_head_apply(params.get("lm_head"), params["embed"], x)
    return logits, cache


# ---------------------------------------------------------------------------
# Input specs (dry-run stand-ins on the meta device, no storage)
# ---------------------------------------------------------------------------

CROSS_LEN_CAP = 4096  # the encoder positions a decode cell's cross KV holds, as in the JAX package
TOKEN_DTYPE = torch.long  # the port's token batches (demo_batch, the controller's batches)


def input_specs(cfg: ModelConfig, shape) -> dict:
    """Meta stand-ins for every model input of a dry-run cell
    (``configs.SHAPES``): the counterpart of the JAX package's
    ``input_specs``.

    train/prefill: the token batch (+ ``frames`` for an enc-dec model).
    decode: a one-token batch, the position and the cache at ``seq_len``
    capacity, and for an enc-dec model the cross KV over ``min(seq_len,
    4096)`` encoder positions. Tokens are in :data:`TOKEN_DTYPE`, what
    the port's batches carry (the JAX package's are int32); ``pos`` is a
    host int, as ``decode_step`` takes it (the JAX package's a scalar
    int32 array)."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        specs = {"tokens": torch.empty((b, s), dtype=TOKEN_DTYPE, device="meta")}
        if cfg.family == "encdec":
            specs["frames"] = torch.empty((b, s, cfg.d_model), dtype=_dtype(cfg.dtype), device="meta")
        return specs
    specs = {
        "tokens": torch.empty((b, 1), dtype=TOKEN_DTYPE, device="meta"),
        "pos": s - 1,
        "cache": abstract_cache(cfg, b, s),
    }
    if cfg.family == "encdec":
        specs["cross_kv"] = kvcache.init_cross_kv(cfg, b, min(s, CROSS_LEN_CAP), device="meta")
    return specs
