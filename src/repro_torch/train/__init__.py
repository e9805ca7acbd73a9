"""Training substrate: optimizer, train step, checkpointing, data, fault
tolerance.

Counterpart of ``repro/train``, with its exports.  Parameters are the
model's own (``model_params(model)``), updated in place; checkpoints are
in the reference's layout.
"""
from .optimizer import (AdamConfig, adam_init, adam_update, lr_schedule,
                        quantize_blockwise, dequantize_blockwise,
                        zero1_specs, opt_state_specs, global_norm)
from .train_step import make_train_step, make_eval_step, model_params
from . import checkpoint
from .data import SyntheticStream, make_batch, shingle_hypergraph, dedup_corpus
from .fault_tolerance import SupervisorConfig, TrainSupervisor

__all__ = [
    "AdamConfig", "adam_init", "adam_update", "lr_schedule",
    "quantize_blockwise", "dequantize_blockwise", "zero1_specs",
    "opt_state_specs", "global_norm", "make_train_step", "make_eval_step",
    "model_params", "checkpoint", "SyntheticStream", "make_batch",
    "shingle_hypergraph", "dedup_corpus", "SupervisorConfig",
    "TrainSupervisor",
]
