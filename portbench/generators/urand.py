"""urand: GAP's uniform random graph (``gapbs -u <scale> -k <k>``):
exactly `edges` distinct undirected pairs drawn uniformly over `vertices`
nodes, no self loops."""
import torch


def _unique_pairs(lo: torch.Tensor, hi: torch.Tensor, n: int) -> torch.Tensor:
    keep = lo != hi
    return torch.unique(lo[keep] * n + hi[keep])


def _take(keys: torch.Tensor, m: int, gen: torch.Generator) -> torch.Tensor:
    """A uniform random subset of exactly `m` of `keys`, sorted."""
    if keys.numel() < m:
        raise ValueError(f"only {keys.numel()} candidate edges for {m}")
    pick = torch.randperm(keys.numel(), generator=gen,
                          device=keys.device)[:m]
    return torch.sort(keys[pick]).values


def edges(config: dict, gen: torch.Generator) -> torch.Tensor:
    """Exactly `edges` distinct uniform random undirected pairs over
    `vertices` nodes, as sorted keys ``lo * n + hi`` of original ids."""
    n, m = int(config["vertices"]), int(config["edges"])
    dev = gen.device
    draw = m + m // 64 + 1024   # covers self loops and repeats
    u = torch.randint(0, n, (draw,), generator=gen, device=dev)
    v = torch.randint(0, n, (draw,), generator=gen, device=dev)
    keys = _unique_pairs(torch.minimum(u, v), torch.maximum(u, v), n)
    return _take(keys, m, gen)
