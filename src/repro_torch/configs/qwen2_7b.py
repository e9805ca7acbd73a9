"""qwen2-7b [dense]: GQA kv=4, QKV bias.  [arXiv:2407.10671; hf]"""
import dataclasses
from ..models.common import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-7b", family="dense",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, d_ff=18944,
    vocab=152064, qkv_bias=True, rope_theta=1e6, microbatch=8,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=256, attn_chunk=0, microbatch=1)
