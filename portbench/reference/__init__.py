"""The plain reference the benchmark judges `correct` by.

Plain PyTorch (any device), written from the definitions and sharing no
code with the program under test: k-core by peeling, connected
components by hooking and pointer jumping, PageRank in float64, triangles
by sorted-key lookups, and the replay of an update stream onto an edge
set.  Every function takes an undirected edge set as sorted keys
``lo * N + hi`` over `N` node ids (``lo < hi``), never the program's
arrays, and imports nothing of the program.
"""
from .graph import directed, degrees, replay
from .kcore import coreness
from .cc import component_labels
from .pagerank import pagerank
from .triangles import triangles

__all__ = ["directed", "degrees", "replay", "coreness", "component_labels",
           "pagerank", "triangles"]
