"""gemma-7b — GeGLU, head_dim=256 [arXiv:2403.08295; hf].

The 7b variant uses num_kv_heads=16 (MQA is only on the 2b variant).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=16,
    num_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    act="gelu",  # GeGLU
    tie_embeddings=True,
    source="arXiv:2403.08295; hf",
)
