"""linear_tpu — an alignment-free long-read mapper / SV-signal filter.

A from-scratch JAX/XLA re-design with the capabilities of the reference
`linear` mapper (see /root/reference): approximate long-read mapping via a
sampled open-syncmer-like minimizer index, dense 2-mer feature-window scoring,
sparse anchor chaining, SV-gap resolution, and SAM/BAM*/APF emission.

Architecture (batched device kernels + a native host engine):
  - `linear_tpu.ops`      device kernels: hashing, features, chaining, extension
  - `linear_tpu.index`    k-mer index build/query (counting-sort tables)
  - `linear_tpu.map`      the mapping engine (batched device pipeline + exact
                          scalar host oracle used as the correctness reference)
  - `linear_tpu.out`      cords -> CIGAR/SAM/APF emission (host)
  - `linear_tpu.utils`    seq I/O, packed-u64 cord bit formats
  - `linear_tpu.parallel` device meshes, sharded multi-chip mapping
"""

__version__ = "0.1.0"

# 64-bit index/cord arithmetic is used on the host and in non-hot device code.
# The hot kernels are written in int32; enabling x64 here does not change them.
import jax

jax.config.update("jax_enable_x64", True)
