"""minitron-8b [dense]: pruned nemotron, 256k vocab.  [arXiv:2407.14679; hf]"""
import dataclasses
from ..models.common import ArchConfig

CONFIG = ArchConfig(
    name="minitron-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=16384,
    vocab=256000, microbatch=8,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=512, attn_chunk=0, microbatch=1)
