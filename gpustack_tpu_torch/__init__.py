"""PyTorch/CUDA port of the serving data plane of ``gpustack_tpu``.

A package of its own beside the JAX one: it imports ``torch`` and nothing
of JAX or of the JAX package. Entry points run on the CUDA card unless the
caller passes ``device="cpu"``; the prefill attention on the card is a
hand-written Hopper kernel (``ops/csrc/flash_attention.cu``).
"""
