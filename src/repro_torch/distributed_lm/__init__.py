"""LM distribution glue: shardings as data, gradient compression.

Counterpart of ``repro/distributed_lm``.  On one card nothing is
placed: the spec functions return what a process group would place
(``models.layers.P``), and ``compressed_allreduce`` runs the int8
all-gather body over the slices of a ``LogicalMesh`` axis in one
process.
"""
from .sharding import (batch_axes, batch_specs, input_structs, shard_params,
                       named, cache_structs, ShapeDtype, NamedSpec)
from .compression import compressed_allreduce

__all__ = ["batch_axes", "batch_specs", "input_structs", "shard_params",
           "named", "cache_structs", "compressed_allreduce", "ShapeDtype",
           "NamedSpec"]
