"""The benchmark of the PyTorch and CUDA port (``dmmfods_tpu_torch``) on one
NVIDIA H100: ``python3 gpubench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``. See ``gpubench/run.py`` and ``PERF.md``."""
