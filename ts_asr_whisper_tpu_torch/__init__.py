"""PyTorch / CUDA port of ts_asr_whisper_tpu for one NVIDIA H100.

Long-form greedy DiCoW decode, with the encoder self-attention in a
hand-written CUDA kernel (kernels/csrc). The JAX package stays the reference
the port is tested against; this package imports torch and never jax.
Run it as ``python -m ts_asr_whisper_tpu_torch <overrides>``.
"""
