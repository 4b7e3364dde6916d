"""Kernels of the port: the backend registry (`ops`), the plain oracles
(`ref`), and the two hand-written CUDA kernels with their wrappers
(`ell_hindex`, `ell_frontier`; sources in `csrc/`, built by `_build`)."""
