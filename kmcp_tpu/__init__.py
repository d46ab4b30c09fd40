"""kmcp-tpu: metagenomic search and taxonomic profiling on JAX.

A from-scratch re-design of the KMCP method (k-mer based metagenomic
classification & profiling; reference implementation: shenwei356/kmcp)
for an accelerator, run on an NVIDIA GPU (and on the CPU for tests):

- k-mer hashing (ntHash1-compatible) vectorized on host (NumPy, C++) and
  on device (XLA),
- a COBS-style bit-sliced Bloom signature index stored as dense uint32
  bit-matrices that live in device memory,
- search as a batched gather -> AND -> positional-popcount -> threshold
  contraction over (reads x k-mers x targets),
- a multi-stage taxonomic profiler with EM abundance estimation on host.

The pipeline mirrors the reference five-command surface:
compute -> index -> search -> merge -> profile (+ utils subcommands).
"""

__version__ = "0.1.0"

# Database/index format version of this implementation (not the reference's).
DB_VERSION = 1
