"""Seconds from the process's start to the window's first step: loading,
tensorizing, the kernels' build on a checkout's first run, and the
warm-up that captures the cell's CUDA graphs (the host's clock)."""


def read(rec):
    return rec.get('setup_s')
