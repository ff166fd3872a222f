"""The port's tooling: one tool for each script of the JAX package's
``scripts/`` that imports jax or the JAX package, with its arguments and
printed lines (``tpu_kernel_check.py`` is ``cuda_kernel_check``,
``submit_tpu.sh`` is ``submit_gpu.sh``). Run one as
``python -m ts_asr_whisper_tpu_torch.scripts.<name>``; nothing runs on
import."""
