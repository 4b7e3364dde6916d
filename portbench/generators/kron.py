"""kron: GAP's Kronecker graph (``gapbs -g <scale> -k <k>``), the Graph500
generator: `edge_factor` * 2^`scale` edge draws over 2^`scale` vertices,
each draw descending `scale` levels of the 2 x 2 initiator (A, B, C, D) =
(0.57, 0.19, 0.19, 0.05) with one uniform number a level, as gapbs
draws them; then made undirected, self loops and repeats dropped,
isolated vertices kept.  gapbs also relabels the vertices by a random
permutation; the benchmark's layout relabels every graph so
(`graphs.make_layout`), which gives the same graph in law."""
import torch


def edges(config: dict, gen: torch.Generator) -> torch.Tensor:
    """The graph's distinct undirected pairs over `vertices` = 2^`scale`
    nodes, as sorted keys ``lo * n + hi`` of original ids."""
    scale, n = int(config["scale"]), int(config["vertices"])
    if n != 1 << scale:
        raise ValueError(f"vertices {n} is not 2^scale = {1 << scale}")
    a, b, c = (float(config["initiator"][k]) for k in ("A", "B", "C"))
    m = int(config["edge_factor"]) << scale
    dev = gen.device
    src = torch.zeros(m, dtype=torch.int64, device=dev)
    dst = torch.zeros(m, dtype=torch.int64, device=dev)
    for _ in range(scale):
        r = torch.rand(m, generator=gen, device=dev)
        down = r >= a + b                   # quadrant C or D: src bit 1
        right = torch.where(down, r >= a + b + c, r >= a)   # B or D
        src.mul_(2).add_(down)
        dst.mul_(2).add_(right)
        del r, down, right
    keep = src != dst
    lo = torch.minimum(src[keep], dst[keep])
    hi = torch.maximum(src[keep], dst[keep])
    del src, dst, keep
    return torch.unique(lo * n + hi)
