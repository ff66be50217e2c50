"""seqalign: Smith-Waterman database search on NVIDIA GPUs, from JAX.

A from-scratch JAX re-design of the capabilities of the reference
AVX2/OpenMP C engine (Aseeef/seq-align-gpu): one-to-many local alignment
(Smith-Waterman with affine gaps, Gotoh formulation), score-exact to the
reference, inter-sequence (one database record per GPU thread) in a CUDA
kernel called through ``jax.ffi``, and data-parallel across devices/hosts.

Layers (mirroring SURVEY.md §1):
  models/   - scoring model, alphabet codec, substitution matrices (L1)
  ops/      - the DP engines: NumPy oracle, XLA paths, CUDA kernel (L2)
  utils/    - FASTA IO, batch packing/bucketing, timing (L0/L3 support)
  parallel/ - device mesh sharding and multi-host search (new capability)
  pipeline  - query-vs-database driver (L3)
  cli       - `smith_waterman`-compatible command line tool (L4)
"""

__version__ = "0.1.0"

from .models import ScoringModel, default_scoring, sw_default_scoring  # noqa: F401
