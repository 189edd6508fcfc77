"""PyTorch and CUDA port of ``rag_uq_tpu``, for NVIDIA Hopper (H100).

The package mirrors the JAX package's module paths. Importing it builds and
launches nothing: kernels and the native tokenizer are built at first use.
Entry points take ``device`` ("cuda" by default) and raise when no card is
present and the caller did not ask for the CPU.
"""
