"""Kernels of the port: the backend registry (`ops`), the plain oracles
(`ref`), and the hand-written CUDA kernels for Hopper with their
wrappers, one per TPU kernel of the JAX package (sources in `csrc/`,
built by `_build`): the ELL kernels `hindex_ell` (with its "count"
variant), `frontier_step_ell`, `neighbor_min_ell`, `neighbor_sum_ell`,
`neighbor_multi_ell` and `neighbor_common_ell` (with its "allpairs"
variant), and the dense kernels `hindex_counts` and `frontier_step`;
`hindex_mirror`, the h-index merge of a hub-split graph's replica
groups, and `union_find_labels`, connected-component labels by
union-find in one pass, which stand for no TPU kernel.  Each wrapper
launches its kernel on CUDA tensors and runs its plain PyTorch version
on CPU tensors."""
from . import ops, ref
from .kcore_hindex import hindex_counts
from .frontier import frontier_step
from .ell_hindex import hindex_ell
from .ell_frontier import frontier_step_ell
from .ell_cc import neighbor_min_ell
from .ell_pagerank import neighbor_sum_ell
from .ell_triangles import neighbor_common_ell
from .ell_multi import neighbor_multi_ell
from .mirror_hindex import hindex_mirror
from .cc_union import union_find_labels

__all__ = [
    "ops", "ref", "hindex_counts", "frontier_step",
    "hindex_ell", "frontier_step_ell",
    "neighbor_min_ell", "neighbor_sum_ell", "neighbor_common_ell",
    "neighbor_multi_ell", "hindex_mirror", "union_find_labels",
]
