"""What the benchmark measures with, which no program change may move:
the traffic generator, the table of peaks and the bytes of each kernel
launch, the reduction of a profiler trace, the FLOP count, the spans the
harness records around the program's calls, and the comparison that
decides ``correct``."""
