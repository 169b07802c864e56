"""chameleon-34b — early-fusion VLM, VQ image tokens [arXiv:2405.09818; unverified].

Early fusion with VQ-VAE image tokens means the image modality lives inside
the 65536-entry token vocabulary; the backbone is a standard decoder-only LM
and ``input_specs()`` provides token ids (mixed text + VQ image tokens).
Chameleon uses qk_norm for training stability.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="dense",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    act="silu",
    qk_norm=True,
    source="arXiv:2405.09818; unverified",
)
