"""ggpm_tpu_torch — the PyTorch/CUDA port of ``ggpm_tpu`` for NVIDIA Hopper.

Serves ``/encode``, ``/properties``, ``/reconstruct`` and ``/sample`` of a
trained prop-opt model (``bridge.load_model`` + ``serve.GgpmServer``), and
trains the motif VAE (``train.loop.Trainer``, ``cli.vae_train``).  Module
names mirror
``ggpm_tpu``; the framework-free layers (``chem``, ``graph``, ``data``) are
copies, so nothing of JAX or of ``ggpm_tpu`` is imported.  Hand-written
kernels live in ``csrc/`` and are built with ``nvcc`` at first use.
"""
