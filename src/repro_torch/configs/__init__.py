"""Configs of the port: the LLM architecture fixtures and the query
service's `ServiceConfig`, as in the JAX package.

  * **Seed fixtures** (`ARCHS`): the 10 LLM architecture configs below,
    with `ShapeConfig`/`SHAPES` and `cell_applicable`, copied field for
    field.  `repro_torch.models` serves the eight decoder-only ones; the
    encoder-decoder is refused there until its step of ROADMAP.md Queue 1
    item 9.  Nothing in `repro_torch.core`/`runtime`/`service` may import
    them.
  * **Service configs** (`service.ServiceConfig`): the graph-side knobs of
    the query-serving layer (`repro_torch.service`).
  * **Graph tasks** (`bladyg_graph.GRAPH_TASKS`): the paper's datasets
    with their protocol parameters.

seed_fixtures: the arch-config population above is quarantined seed
substrate, as in the JAX package; the package itself is reachable from
the service, which imports `ServiceConfig`.
"""
from .base import ArchConfig, ShapeConfig, SHAPES, SHAPES_BY_NAME, cell_applicable
from .service import ServiceConfig

from .seamless_m4t_large_v2 import CONFIG as seamless_m4t_large_v2
from .mamba2_370m import CONFIG as mamba2_370m
from .deepseek_v3_671b import CONFIG as deepseek_v3_671b
from .llama4_scout_17b_a16e import CONFIG as llama4_scout_17b_a16e
from .gemma3_1b import CONFIG as gemma3_1b
from .codeqwen1_5_7b import CONFIG as codeqwen1_5_7b
from .granite_34b import CONFIG as granite_34b
from .internlm2_1_8b import CONFIG as internlm2_1_8b
from .zamba2_7b import CONFIG as zamba2_7b
from .paligemma_3b import CONFIG as paligemma_3b

ARCHS = {
    c.name: c
    for c in (
        seamless_m4t_large_v2,
        mamba2_370m,
        deepseek_v3_671b,
        llama4_scout_17b_a16e,
        gemma3_1b,
        codeqwen1_5_7b,
        granite_34b,
        internlm2_1_8b,
        zamba2_7b,
        paligemma_3b,
    )
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = [
    "ArchConfig", "ShapeConfig", "SHAPES", "SHAPES_BY_NAME",
    "cell_applicable", "ARCHS", "get_arch", "ServiceConfig",
]
