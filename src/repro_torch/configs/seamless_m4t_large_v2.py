"""seamless-m4t-large-v2 — enc-dec multimodal (audio) [arXiv:2308.11596; hf].

The assignment specifies the transformer BACKBONE only: 24L d_model=1024 16H
(GQA kv=16) d_ff=8192 vocab=256206. We realize it as a 24-layer speech
encoder + 24-layer text decoder (the seamless v2 layout); the audio frontend
is a STUB — ``input_specs()`` provides precomputed frame embeddings
(batch, frames, d_model).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    num_layers=24,
    encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    act="silu",
    frontend="audio_frames",
    source="arXiv:2308.11596; hf",
)
