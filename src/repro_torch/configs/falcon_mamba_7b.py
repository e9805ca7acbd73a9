"""falcon-mamba-7b [ssm]: 64 Mamba-1 blocks, attention-free.
[arXiv:2410.05355; unverified]"""
import dataclasses
from ..models.common import ArchConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=1, n_kv_heads=1, d_ff=0,
    vocab=65024, ssm_state=16, d_conv=4, expand=2, scan_chunk=256,
    microbatch=8,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, vocab=256, ssm_state=4, scan_chunk=8,
    microbatch=1)
