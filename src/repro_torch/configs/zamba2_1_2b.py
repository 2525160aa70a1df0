"""zamba2-1.2b — hybrid Mamba2 backbone with shared attention blocks.

38L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=32000 ssm_state=64
[arXiv:2411.15242; hf].  Block pattern: 5 mamba2 blocks then one shared
attention block (weights of all ``shared_attention`` layers are tied),
cycled across the 38 layers — the Zamba2 shared-block topology.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    block_pattern=(
        "mamba2", "mamba2", "mamba2", "mamba2", "mamba2", "shared_attention",
    ),
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, chunk_size=256),
    source="arXiv:2411.15242; hf",
)
