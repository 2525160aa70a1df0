"""rwkv6-1.6b (Finch) — attention-free, data-dependent decay.

24L d_model=2048 d_ff=7168 vocab=65536 [arXiv:2404.05892; unverified].
"""
from repro_torch.configs.base import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=32,  # wkv heads = d_model / head_dim
    num_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    block_pattern=("rwkv6",),
    rwkv=RWKVConfig(head_dim=64, decay_lora=64, gate_lora=64),
    source="arXiv:2404.05892; unverified",
)
