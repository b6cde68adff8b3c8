"""finito_tpu_torch: the PyTorch and CUDA port of finito_tpu.

The JAX package ``finito_tpu`` stays the reference; this package is the
second implementation beside it, for one NVIDIA H100. It ports only
code that imports jax, and imports the jax-free host layers of
``finito_tpu`` (io, sbwt, index, native, the CLI's output loop) without
copying them, so index files, output bytes and stats files stay
identical by construction. It imports torch and never jax.

Layout mirrors finito_tpu:
  ops/     bits (32-bit word convention), minimizer_front (front-end
           kernel + plain version), streaming (compact_mask), _build
  csrc/    hand-written CUDA kernels for sm_90a
  query/   minimizer_tables (numpy table builders), minimizer_engine
           (device index + v1 locate), engine (DeviceQueryEngine)
  cli      search-fmin on the port; other commands pass through
"""
