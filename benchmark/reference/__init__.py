"""The benchmark's plain reference of the two trained model families.

A frozen copy, in plain PyTorch and float32, of what the port's training
step computes for the ``prop`` and ``hier-prop`` models: the checkpoint
reader (``checkpoint``), the tensorization of SMILES into padded batches
(``chem``, ``graph``, ``data``), both models' training losses
(``models``), and Adam with global-norm clipping and the per-epoch decay
(``adam``).  It imports nothing of the port, of the JAX package or of
JAX: the benchmark hands it the same SMILES, checkpoint and seed as the
program, and it works every table out again.
"""
