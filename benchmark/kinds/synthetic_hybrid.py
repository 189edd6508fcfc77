"""The ``synthetic_hybrid`` kind: a seeded corpus, the port's hybrid
retriever over it, and the retrieval judge (``deploy.py``, ``check.py``)."""

from benchmark.check import run as judge  # noqa: F401
from benchmark.deploy import build, make_inputs  # noqa: F401
