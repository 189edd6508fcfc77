"""Native host runtime bindings (C++ tokenizer / vocabulary / postings)."""

from rag_uq_tpu_torch.native.binding import NativeTokenizer, is_available

__all__ = ["NativeTokenizer", "is_available"]
