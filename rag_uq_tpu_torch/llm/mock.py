"""Deterministic mock generator (test double): a copy of ``rag_uq_tpu/llm/mock.py``.

Cycles through canned responses and counts calls.
"""

from __future__ import annotations

from typing import List, Optional, Sequence


class MockLLM:
    def __init__(self, responses: Optional[Sequence[str]] = None):
        self.responses = list(responses) if responses else ["This is a mock answer."]
        self.call_count = 0

    def generate(
        self,
        prompt: str,
        temperature: float = 0.1,
        top_p: float = 0.9,
        max_tokens: int = 100,
        seed: Optional[int] = None,
    ) -> str:
        response = self.responses[self.call_count % len(self.responses)]
        self.call_count += 1
        return response

    def generate_batch(
        self,
        prompts: Sequence[str],
        temperatures: Sequence[float],
        top_ps: Sequence[float],
        max_tokens: int = 100,
        seed: Optional[int] = None,
    ) -> List[str]:
        return [
            self.generate(p, t, tp, max_tokens)
            for p, t, tp in zip(prompts, temperatures, top_ps)
        ]
