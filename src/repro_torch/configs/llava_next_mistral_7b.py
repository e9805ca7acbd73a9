"""llava-next-mistral-7b [vlm]: mistral-7b backbone + anyres patch stub.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]"""
import dataclasses
from ..models.common import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=32000, rope_theta=1e6, vision_dim=1024, num_patches=576,
    microbatch=8,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=256, vision_dim=16, num_patches=4, attn_chunk=0, microbatch=1)
