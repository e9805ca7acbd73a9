"""qwen2-moe-a2.7b [moe]: 4 shared + 60 routed experts, top-4.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]"""
import dataclasses
from ..models.common import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab=151936, n_experts=60, top_k=4, n_shared_experts=4, moe_d_ff=1408,
    expert_sharding="ffn", microbatch=16,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=64,
    vocab=256, n_experts=8, top_k=2, n_shared_experts=1, moe_d_ff=64,
    attn_chunk=0, microbatch=1)
