"""The reference's examples on the port, each on the card unless asked
for the host:

    python -m repro_torch.examples.<name> [--device cpu]

for the four reachability examples ``quickstart``, ``serving_quickstart``,
``epidemic_case_study`` and ``distributed_reachability``, and the LM
examples ``serve_lm`` and ``train_lm``.  Each module's ``main(device=...)``
prints what the reference's prints, keeps its assertions and returns its
answers.
"""
