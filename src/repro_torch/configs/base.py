"""Model / parallelism / shape configuration dataclasses.

Every assigned architecture is expressed as a :class:`ModelConfig`; the four
assigned input shapes are :data:`SHAPES`. ``reduced()`` produces the smoke-test
variant of a config (same family, tiny dims).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Optional


# ---------------------------------------------------------------------------
# Input shapes (assigned; identical set for all 10 LM-family archs)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 => d_model // num_heads
    act: str = "silu"  # silu => SwiGLU; gelu => GeGLU
    norm: str = "rmsnorm"
    qk_norm: bool = False
    qkv_bias: bool = False
    sliding_window: int = 0  # 0 => full attention
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_period: int = 1  # a layer l is MoE iff num_experts>0 and l % moe_period == moe_period-1
    moe_shared_expert: bool = False
    moe_capacity_factor: float = 1.25
    # SSM / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_chunk: int = 64
    attn_period: int = 0  # hybrid: layer l is attention iff (l % attn_period == attn_period-1)
    # encoder-decoder
    encoder_layers: int = 0
    # modality frontend stub: None | "audio_frames" | "vision_patches"
    frontend: Optional[str] = None
    # training numerics
    dtype: str = "bfloat16"  # activation/compute dtype
    param_dtype: str = "float32"
    # provenance tag from the assignment table
    source: str = ""

    # ---- derived -----------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def layer_kind(self, layer_idx: int) -> str:
        """'attn' | 'ssm' for the mixer of decoder layer ``layer_idx``."""
        if self.family == "ssm":
            return "ssm"
        if self.family == "hybrid" and self.attn_period > 0:
            return (
                "attn"
                if (layer_idx % self.attn_period == self.attn_period - 1)
                else "ssm"
            )
        return "attn"

    def is_moe_layer(self, layer_idx: int) -> bool:
        return self.num_experts > 0 and (
            layer_idx % self.moe_period == self.moe_period - 1
        )

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Eligible for long_500k: SSM / hybrid / windowed attention."""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    def param_count(self) -> int:
        """Analytic parameter count (matches the built model; used for
        MODEL_FLOPS and memory napkin math)."""
        from repro_torch.models.model import analytic_param_count

        return analytic_param_count(self)

    def active_param_count(self) -> int:
        from repro_torch.models.model import analytic_param_count

        return analytic_param_count(self, active_only=True)

    def reduced(self) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests."""
        kv = min(self.num_kv_heads, 2)
        heads = max(kv, min(self.num_heads, 4))
        return replace(
            self,
            name=self.name + "-reduced",
            num_layers=min(self.num_layers, 4)
            if self.attn_period == 0
            else max(self.attn_period, 4),
            encoder_layers=min(self.encoder_layers, 2),
            d_model=64,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=16 if self.head_dim else 0,
            d_ff=128,
            vocab_size=512,
            num_experts=min(self.num_experts, 4),
            # no token dropping in smoke/consistency tests (capacity >= k*s)
            moe_capacity_factor=float(max(self.num_experts, 1)),
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_chunk=8 if self.ssm_state else 64,
            dtype="float32",
        )

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------------
# Parallelism configuration (logical; the Abstract Resource View consumes it)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ParallelConfig:
    """Logical parallel decomposition. world = dp * pp * tp * ep_outer.

    ``ep`` subdivides expert storage *within* the tp dimension group for MoE
    models when ``ep_inner`` is True; by default ep is an independent axis.
    """

    dp: int = 1
    pp: int = 1
    tp: int = 1
    ep: int = 1

    @property
    def world_size(self) -> int:
        return self.dp * self.pp * self.tp * self.ep

    def rank_coords(self, rank: int) -> tuple[int, int, int, int]:
        """rank -> (dp_idx, pp_idx, ep_idx, tp_idx); tp fastest-varying."""
        assert 0 <= rank < self.world_size
        tp_i = rank % self.tp
        rest = rank // self.tp
        ep_i = rest % self.ep
        rest //= self.ep
        pp_i = rest % self.pp
        dp_i = rest // self.pp
        return (dp_i, pp_i, ep_i, tp_i)

    def coords_rank(self, dp_i: int, pp_i: int, ep_i: int, tp_i: int) -> int:
        return ((dp_i * self.pp + pp_i) * self.ep + ep_i) * self.tp + tp_i

    def describe(self) -> str:
        return f"dp{self.dp}xpp{self.pp}xtp{self.tp}" + (
            f"xep{self.ep}" if self.ep > 1 else ""
        )


@dataclass(frozen=True)
class TrainConfig:
    """End-to-end training hyperparameters."""

    model: ModelConfig
    seq_len: int = 1024
    global_batch: int = 8
    microbatches: int = 1  # gradient accumulation steps
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    remat: str = "full"  # none | full | dots
    grad_compression: str = "none"  # none | int8_ef
    seed: int = 0
