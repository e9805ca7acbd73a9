"""The reference's four reachability examples on the port, each on the
card unless asked for the host:

    python -m repro_torch.examples.<name> [--device cpu]

for ``quickstart``, ``serving_quickstart``, ``epidemic_case_study`` and
``distributed_reachability``.  Each module's ``main(device=...)`` prints
what the reference's prints, keeps its assertions and returns its answers.
"""
