"""The benchmark of the PyTorch/CUDA port (``ggpm_tpu_torch``): one
command runs one cell of ``BENCHMARK.json`` once (``run.py``)."""
