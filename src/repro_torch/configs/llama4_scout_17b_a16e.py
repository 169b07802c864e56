"""llama4-scout-17b-a16e — MoE top-1 (16 experts) + shared expert, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

Early-fusion vision: the modality frontend is a STUB providing precomputed
patch embeddings; the backbone below is what the dry-run exercises.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    num_experts=16,
    experts_per_token=1,
    moe_shared_expert=True,
    frontend="vision_patches",
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
)
