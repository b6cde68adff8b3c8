"""finito_tpu_torch: the PyTorch and CUDA port of finito_tpu.

The JAX package ``finito_tpu`` stays the reference; this package is the
second implementation beside it, for one NVIDIA H100. It shares no code
with it: the host layers are the port's own copies under the same module
names, and the tests hold their files and outputs byte-identical to the
JAX package's. It imports torch and never jax.

Layout mirrors finito_tpu:
  utils/   bits, logging, bounded_deque, tune_host_allocator
  native/  the C++ host library (g++ at first use) and its loader
  io/      sdsl, seqdb, fastx, algbio_sbwt, kmidx
  sbwt/    plain-matrix SBWT, k-mer keys, construction, LCS
  index/   packed_strings, FinimizerIndex, MinimizerIndex, builder
  utils/synth        the repeat-dense workload and its index-free oracle
  ops/     bits (32-bit word convention), minimizer_front (front-end
           kernel + plain version), streaming (compact_mask), _build
  csrc/    hand-written CUDA kernels for sm_90a
  query/   oracle, minimizer_tables (numpy table builders),
           minimizer_engine (device index + v1/v2 locate), engine
           (DeviceQueryEngine, make_device_pipeline)
  dbg, stats_modes   unitig construction, build-fmin's stats modes
  cli, kmer_mapper   the command line (host commands on the CPU,
                     search-fmin and kmer-mapper on --device)
"""

from finito_tpu_torch.version import __version__

__all__ = ["__version__"]
