"""The port's benchmark suite: the reference's ``benchmarks/`` scripts on
``repro_torch``, each on the card unless asked for the host.

``python -m repro_torch.benchmarks.<script> [--quick] [--device cpu]``
for ``run`` (the paper tables as CSV), ``kernels_bench``,
``bench_serving``, ``bench_service_scale``, ``bench_workloads``,
``bench_persistence``, ``bench_maintenance``, ``bench_construction`` and
``bench_sharded``; each writes ``build/bench_torch/BENCH_<name>.json``
(``--out`` to change it).  ``roofline`` holds the H100's rates and each
kernel's bound, ``datasets`` the seeded stand-in graphs.  Importing this
package imports none of them.
"""
