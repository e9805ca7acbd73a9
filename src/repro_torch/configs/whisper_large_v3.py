"""whisper-large-v3 [audio]: enc-dec backbone, conv frontend stubbed
(input_specs supplies 1500 precomputed frame embeddings).
[arXiv:2212.04356; unverified]"""
import dataclasses
from ..models.common import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3", family="encdec",
    n_layers=32, enc_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
    d_ff=5120, vocab=51866, enc_frames=1500, tie_embeddings=True,
    microbatch=4,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=256, enc_frames=8, attn_chunk=0, microbatch=1)
