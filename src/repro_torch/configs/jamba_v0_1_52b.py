"""jamba-v0.1-52b — hybrid Mamba+attention 1:7 interleave, MoE [arXiv:2403.19887; hf].

Layer l is an attention mixer iff l % 8 == 7 (1 attention : 7 mamba); MoE MLP
on every 2nd layer with 16 experts top-2. We use the Mamba-2 SSD formulation
for the SSM mixer uniformly across the repo (Jamba v0.1 ships Mamba-1; see
DESIGN.md for the documented deviation).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    num_experts=16,
    experts_per_token=2,
    moe_period=2,
    attn_period=8,
    ssm_state=128,
    source="arXiv:2403.19887; hf",
)
