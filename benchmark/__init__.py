"""Benchmark of the PyTorch and CUDA port (``ts_asr_whisper_tpu_torch``) on
an NVIDIA H100: ``python3 benchmark/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``. ``BENCHMARK.json`` at the repository root
lists the cells, configurations and metrics; each lives in files of its own
here, found by name."""
