"""qwen3-1.7b [dense]: qk_norm, GQA kv=8.  [hf:Qwen/Qwen3-8B; hf]"""
import dataclasses
from ..models.common import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-1.7b", family="dense",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8, d_ff=6144,
    vocab=151936, qk_norm=True, head_dim=128, rope_theta=1e6, microbatch=4,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=256, head_dim=16, attn_chunk=0, microbatch=1)
