"""GPT-family configs matching the model sizes in the LiveR paper's
evaluation (GPT-1.7B ... GPT-70B). Used by the reconfiguration benchmarks
(Fig. 6, 10, 11) and the simulator; llama-ish shapes at the stated sizes.
"""

from repro_torch.configs.base import ModelConfig


def _gpt(name, layers, d_model, heads, kv, d_ff, vocab=50304):
    return ModelConfig(
        name=name,
        family="dense",
        num_layers=layers,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        d_ff=d_ff,
        vocab_size=vocab,
        source="LiveR paper evaluation family",
    )


GPT_1_7B = _gpt("gpt-1.7b", 24, 2304, 24, 24, 9216)
GPT_7B = _gpt("gpt-7b", 32, 4096, 32, 32, 11008)
GPT_14B = _gpt("gpt-14b", 40, 5120, 40, 40, 13824)
GPT_20B = _gpt("gpt-20b", 44, 6144, 48, 48, 16384)
GPT_30B = _gpt("gpt-30b", 48, 7168, 56, 56, 19200)
GPT_70B = _gpt("gpt-70b", 80, 8192, 64, 8, 28672)

GPT_FAMILY = {
    c.name: c for c in [GPT_1_7B, GPT_7B, GPT_14B, GPT_20B, GPT_30B, GPT_70B]
}
