"""Generic graph utilities and spanning trees.

A copy of ``albatross_tpu.utils.graph``, which imports no JAX: Kruskal's
spanning forests with union-find and Prim's spanning trees, after the
reference's ``graph/minimum_spanning_tree.hpp`` (used, for example, to
choose which pairs of a network to difference).  Host-side combinatorial
code: it feeds structure to the device compute, so it stays plain Python.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Generic, Hashable, List, Set, TypeVar

V = TypeVar("V", bound=Hashable)


@dataclasses.dataclass(frozen=True)
class Edge(Generic[V]):
    a: V
    b: V
    cost: float = 0.0

    def reversed(self) -> "Edge":
        return Edge(self.b, self.a, self.cost)


@dataclasses.dataclass
class Graph(Generic[V]):
    edges: List[Edge] = dataclasses.field(default_factory=list)

    def add_edge(self, a: V, b: V, cost: float = 0.0) -> None:
        self.edges.append(Edge(a, b, cost))

    def vertices(self) -> Set[V]:
        return compute_vertices(self.edges)

    def adjacency(self) -> Dict[V, List[Edge]]:
        adj: Dict[V, List[Edge]] = {}
        for e in self.edges:
            adj.setdefault(e.a, []).append(e)
            adj.setdefault(e.b, []).append(e.reversed())
        return adj


class _UnionFind(Generic[V]):
    def __init__(self):
        self.parent: Dict[V, V] = {}

    def find(self, v: V) -> V:
        self.parent.setdefault(v, v)
        root = v
        while self.parent[root] != root:
            root = self.parent[root]
        while self.parent[v] != root:
            self.parent[v], v = root, self.parent[v]
        return root

    def union(self, a: V, b: V) -> bool:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return False
        self.parent[ra] = rb
        return True


def compute_vertices(edges: List[Edge]) -> Set:
    """Unique vertices touched by ``edges``
    (minimum_spanning_tree.hpp:40-49)."""
    out: Set = set()
    for e in edges:
        out.add(e.a)
        out.add(e.b)
    return out


def create_graph(edges: List[Edge]) -> Graph:
    """Graph from an edge list (minimum_spanning_tree.hpp:56-62)."""
    return Graph(list(edges))


def minimum_spanning_forest(graph: Graph) -> Graph:
    """Kruskal's minimum spanning forest (minimum_spanning_tree.hpp:228-235):
    spans EVERY connected component; ties broken by edge insertion order for
    determinism."""
    uf = _UnionFind()
    out = Graph()
    for edge in sorted(graph.edges, key=lambda e: e.cost):
        if uf.union(edge.a, edge.b):
            out.edges.append(edge)
    return out


def maximum_spanning_forest(graph: Graph) -> Graph:
    flipped = Graph([Edge(e.a, e.b, -e.cost) for e in graph.edges])
    msf = minimum_spanning_forest(flipped)
    return Graph([Edge(e.a, e.b, -e.cost) for e in msf.edges])


def maximum_spanning_tree(graph: Graph) -> Graph:
    """Prim's maximum spanning tree (minimum_spanning_tree.hpp:119-157):
    grows from the maximum-cost edge's first vertex, so unlike the *forest*
    variants it spans only that connected component."""
    import heapq

    if not graph.edges:
        return Graph()
    adjacency = graph.adjacency()
    start = max(graph.edges, key=lambda e: e.cost).a
    n_vertices = len(graph.vertices())

    out = Graph()
    seen = {start}
    counter = 0  # deterministic FIFO tie-break on equal costs
    queue: List = []
    for edge in adjacency[start]:
        heapq.heappush(queue, (-edge.cost, counter, edge))
        counter += 1
    while queue and len(out.edges) < n_vertices - 1:
        _, _, edge = heapq.heappop(queue)
        if edge.b in seen:
            continue
        seen.add(edge.b)
        out.edges.append(edge)
        for nxt in adjacency[edge.b]:
            if nxt.b not in seen:
                heapq.heappush(queue, (-nxt.cost, counter, nxt))
                counter += 1
    return out


def minimum_spanning_tree(graph: Graph) -> Graph:
    """Prim's minimum spanning tree via cost negation
    (minimum_spanning_tree.hpp:242-253); single connected component —
    use :func:`minimum_spanning_forest` for disjoint graphs."""
    flipped = Graph([Edge(e.a, e.b, -e.cost) for e in graph.edges])
    mst = maximum_spanning_tree(flipped)
    return Graph([Edge(e.a, e.b, -e.cost) for e in mst.edges])
