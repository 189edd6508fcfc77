"""Corpus sharding over a ``torch.distributed`` process group."""
