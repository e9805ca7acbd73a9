"""Repository tools of the port: ``check_docs`` holds
``docs/ARCHITECTURE_TORCH.md`` to the port's registries.
"""
