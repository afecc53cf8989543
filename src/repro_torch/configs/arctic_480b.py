"""arctic-480b [moe] — 128 experts top-2 + dense residual [hf:Snowflake/snowflake-arctic-base].

35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000, MoE 128e top-2 with a
dense FFN residual branch running in parallel (Arctic's dense-MoE hybrid).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, reduced as _reduced

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    act="silu",
    moe=MoEConfig(num_experts=128, top_k=2, dense_residual=True),
    source="Snowflake Arctic 480B [hf:Snowflake/snowflake-arctic-base]",
)


def reduced():
    return _reduced(CONFIG)
