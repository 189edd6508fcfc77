"""Clean-room stand-ins for third-party packages the reference depends on.

Used by the parity harness (cli/parity_e2e.py) to execute the REFERENCE
code as-is without network access. See shims.py.
"""

from rag_uq_tpu_torch.compat.shims import install_shims

__all__ = ["install_shims"]
