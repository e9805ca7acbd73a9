"""qwen2.5-14b [dense]: GQA kv=8, QKV bias.  [hf:Qwen/Qwen2.5-0.5B; hf]"""
import dataclasses
from ..models.common import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-14b", family="dense",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=13824,
    vocab=152064, qkv_bias=True, rope_theta=1e6, microbatch=8,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=256, attn_chunk=0, microbatch=1)
