"""arctic-480b [moe]: 128 experts top-2 + parallel dense residual MLP.
EP over model x data axes, 8-bit Adam + ZeRO-1 (DESIGN.md 5).
[hf:Snowflake/snowflake-arctic-base; hf]"""
import dataclasses
from ..models.common import ArchConfig

CONFIG = ArchConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=4864,
    vocab=32000, n_experts=128, top_k=2, moe_d_ff=4864, dense_residual=True,
    expert_sharding="model+data", opt_8bit=True, microbatch=16,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=96,
    vocab=256, n_experts=8, top_k=2, moe_d_ff=96, expert_sharding="ffn",
    attn_chunk=0, microbatch=1, opt_8bit=True)
