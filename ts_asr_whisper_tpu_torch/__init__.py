"""PyTorch / CUDA port of ts_asr_whisper_tpu for one NVIDIA H100.

Long-form greedy and beam-5 joint-CTC DiCoW decode, and the DiCoW v3
fine-tune, with the JAX package's Pallas kernels rewritten by hand for
Hopper (kernels/csrc). The JAX package stays the reference the port is
tested against; this package imports torch, never jax, and nothing of the
JAX package (it keeps its own copies of the host modules it needs). Run it
as ``python -m ts_asr_whisper_tpu_torch [--device {cuda,cpu}] <overrides>``.
"""
