"""Generator protocol: a copy of ``rag_uq_tpu/llm/base.py``."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Protocol, Sequence, runtime_checkable


@dataclass
class GenerationResult:
    text: str


@runtime_checkable
class Generator(Protocol):
    """Text generator interface.

    ``generate`` takes the sampling knobs (temperature, top_p, max_tokens);
    ``generate_batch`` produces one sample a prompt with per-sample
    temperature and top_p in one call, so K MC samples are one batch.
    """

    def generate(
        self,
        prompt: str,
        temperature: float = 0.1,
        top_p: float = 0.9,
        max_tokens: int = 100,
        seed: Optional[int] = None,
    ) -> str:
        ...

    def generate_batch(
        self,
        prompts: Sequence[str],
        temperatures: Sequence[float],
        top_ps: Sequence[float],
        max_tokens: int = 100,
        seed: Optional[int] = None,
    ) -> List[str]:
        ...
