"""Distributed maximal clique maintenance — BLADYG application #3 (paper §4.3).

The algorithm is [Xu, Cheng, Fu, Bu 2014]'s incremental MCE: on inserting
(u, v), cliques contained in (adj(u) ∩ adj(v)) ∪ {u, v} that contain u or v
may become non-maximal and are removed; the new maximal cliques are those of
the subgraph induced by the common neighborhood, extended by {u, v}.  On
deleting (u, v), every clique containing both splits into two candidate
cliques which are re-maximalized.

Host note: prefix-tree maintenance over data-dependent clique sets is
pointer-chasing, combinatorial work with no GPU analogue — the paper
itself runs it inside CPU actors.  MCE therefore stays host-side, pure
Python as in the JAX package; it needs no torch.

The per-node prefix tree T_u of the paper is represented as the set of
maximal cliques indexed by their minimum vertex (the tree root); this keeps
the same asymptotics for the paper's operations (locate cliques rooted at u,
insert/delete a root-to-leaf path == a clique).
"""
from __future__ import annotations

from typing import Dict, FrozenSet, Iterable, List, Set, Tuple

Clique = FrozenSet[int]


def bron_kerbosch(adj: Dict[int, Set[int]], subset: Set[int] | None = None) -> List[Clique]:
    """Maximal cliques (with pivoting).  `subset`: restrict to induced subgraph."""
    if subset is not None:
        adj = {u: (adj[u] & subset) for u in subset}
    out: List[Clique] = []

    def expand(r: Set[int], p: Set[int], x: Set[int]):
        if not p and not x:
            out.append(frozenset(r))
            return
        pivot = max(p | x, key=lambda w: len(adj[w] & p))
        for v in list(p - adj[pivot]):
            expand(r | {v}, p & adj[v], x & adj[v])
            p.remove(v)
            x.add(v)

    expand(set(), set(adj.keys()), set())
    return out


class MaximalCliques:
    """Maintained set of maximal cliques of a dynamic undirected graph."""

    def __init__(self, n: int, edges: Iterable[Tuple[int, int]] = ()):
        self.adj: Dict[int, Set[int]] = {u: set() for u in range(n)}
        for a, b in edges:
            if a != b:
                self.adj[a].add(b)
                self.adj[b].add(a)
        self.cliques: Set[Clique] = set(bron_kerbosch(self.adj))
        # paper's T_u: cliques indexed by root (minimum vertex)
        self.by_root: Dict[int, Set[Clique]] = {}
        for c in self.cliques:
            self.by_root.setdefault(min(c), set()).add(c)

    # -- internal index maintenance ---------------------------------------
    def _add(self, c: Clique):
        if c not in self.cliques:
            self.cliques.add(c)
            self.by_root.setdefault(min(c), set()).add(c)

    def _remove(self, c: Clique):
        if c in self.cliques:
            self.cliques.discard(c)
            r = min(c)
            self.by_root[r].discard(c)
            if not self.by_root[r]:
                del self.by_root[r]

    # -- updates ------------------------------------------------------------
    def insert_edge(self, u: int, v: int) -> Tuple[int, int]:
        """Returns (#cliques added, #removed) — the workerCompute payload."""
        if v in self.adj[u]:
            return (0, 0)
        common = self.adj[u] & self.adj[v]
        self.adj[u].add(v)
        self.adj[v].add(u)
        # 1) existing cliques that become non-maximal: contain u or v and are
        #    a subset of common ∪ {u, v}   [Xu et al., paper §4.3]
        closure = common | {u, v}
        dead = [
            c
            for c in self.cliques
            if (u in c or v in c) and c <= closure
        ]
        # 2) new maximal cliques: {u, v} ∪ C for C maximal in G[common]
        if common:
            born = [c | {u, v} for c in bron_kerbosch(self.adj, common)]
        else:
            born = [frozenset({u, v})]
        for c in dead:
            self._remove(c)
        added = 0
        for c in born:
            if c not in self.cliques:
                self._add(c)
                added += 1
        return (added, len(dead))

    def delete_edge(self, u: int, v: int) -> Tuple[int, int]:
        if v not in self.adj[u]:
            return (0, 0)
        self.adj[u].discard(v)
        self.adj[v].discard(u)
        dead = [c for c in self.cliques if u in c and v in c]
        added = 0
        for c in dead:
            self._remove(c)
        for c in dead:
            for w in (u, v):
                cand = set(c) - {v if w == u else u}
                # re-maximalize cand in the new graph
                ext = self._maximalize(cand)
                if ext not in self.cliques and self._is_maximal(ext):
                    self._add(ext)
                    added += 1
        return (added, len(dead))

    def _maximalize(self, c: Set[int]) -> Clique:
        cand = set(c)
        common = set.intersection(*(self.adj[x] for x in cand)) - cand
        while common:
            w = min(common)  # deterministic
            cand.add(w)
            common &= self.adj[w]
            common -= {w}
        return frozenset(cand)

    def _is_maximal(self, c: Clique) -> bool:
        common = set.intersection(*(self.adj[x] for x in c)) - set(c)
        return not common

    def check(self) -> bool:
        """Invariant: every stored clique is a clique and maximal."""
        for c in self.cliques:
            for a in c:
                if not (c - {a}) <= self.adj[a]:
                    return False
            if not self._is_maximal(c):
                return False
        return True
