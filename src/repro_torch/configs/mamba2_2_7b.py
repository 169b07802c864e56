"""mamba2-2.7b — attention-free SSD (state-space duality) [arXiv:2405.21060; unverified].

d_ff=0: Mamba-2 blocks have no separate MLP; the block expands d_model by
``ssm_expand`` (=2 -> d_inner=5120) internally. num_heads below follows the
Mamba-2 convention d_inner / head_dim with head_dim=64 -> 80 heads.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=80,  # d_inner(5120) / head_dim(64)
    num_kv_heads=80,
    head_dim=64,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    source="arXiv:2405.21060; unverified",
)
