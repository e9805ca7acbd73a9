"""recurrentgemma-2b [hybrid]: RG-LRU + local attention (window 2048),
pattern (rec, rec, attn); MQA kv=1.  [arXiv:2402.19427; hf]"""
import dataclasses
from ..models.common import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, d_ff=7680,
    vocab=256000, window=2048, head_dim=256, block_pattern=("rec", "rec", "attn"),
    d_rnn=2560, tie_embeddings=True, microbatch=4,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=6, d_model=64, n_heads=4, n_kv_heads=1, d_ff=128,
    vocab=256, window=8, head_dim=16, d_rnn=64, attn_chunk=0, microbatch=1)
