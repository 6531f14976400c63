"""Static skeleton topology: edge graph, neighbourhoods, pooling cascade.

A numpy copy of ``hm_vae_tpu.ops.topology`` (which the port may not import:
that package pulls in JAX).  Everything here is build-time metadata computed
once per configuration:

- a virtual root edge ``(0, n_joints)`` is prepended, so edge index equals
  joint index and the root survives pooling;
- chain pooling splits at joints of degree > 2;
- edge neighbourhoods come from all-pairs edge distance (Floyd-Warshall);
- the SMPL-24 cascade is 24 -> 14 -> 9 -> 7 edges.
"""

from __future__ import annotations

import functools
import os
from typing import List, Sequence, Tuple

import numpy as np

# SMPL 24-joint parent list (same content as assets/joint24_parents.json)
SMPL24_PARENTS: Tuple[int, ...] = (
    -1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19,
    20, 21,
)

ASSETS_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets")

Edge = Tuple[int, int]


def edges_from_parents(parents: Sequence[int]) -> List[Edge]:
    """Edge list with a leading virtual root edge ``(0, n_joints)``."""
    n = len(parents)
    return [(0, n)] + [(parents[i], i) for i in range(1, n)]


def edge_distance_matrix(edges: Sequence[Edge]) -> np.ndarray:
    """All-pairs edge distance: edges sharing a vertex are at distance 1."""
    ev = np.asarray(edges, dtype=np.int64)
    shares = (
        (ev[:, None, 0] == ev[None, :, 0])
        | (ev[:, None, 0] == ev[None, :, 1])
        | (ev[:, None, 1] == ev[None, :, 0])
        | (ev[:, None, 1] == ev[None, :, 1])
    )
    big = np.iinfo(np.int64).max // 4
    dist = np.where(shares, 1, big)
    np.fill_diagonal(dist, 0)
    for k in range(len(edges)):
        dist = np.minimum(dist, dist[:, k : k + 1] + dist[k : k + 1, :])
    return dist


def neighbour_lists(edges: Sequence[Edge], d: int) -> List[List[int]]:
    """Per-edge list of edge indices within graph distance ``d``."""
    dist = edge_distance_matrix(edges)
    return [list(np.nonzero(dist[i] <= d)[0]) for i in range(len(edges))]


def pool_edges(
    edges: Sequence[Edge], last_pool: bool = False
) -> Tuple[List[List[int]], List[List[int]], List[Edge]]:
    """Chain-merging pooling of one level: ``(seq_list, pooling_list, new_edges)``.

    Chains run from the root (or a joint of degree > 2) toward the leaves;
    consecutive edge pairs merge and an odd chain keeps its first edge alone.
    With ``last_pool`` each chain collapses whole and no edge list is made.
    """
    degree: dict[int, int] = {}
    for a, b in edges:
        degree[a] = degree.get(a, 0) + 1
        degree[b] = degree.get(b, 0) + 1

    seq_list: List[List[int]] = []

    def find_seq(j: int, seq: List[int]) -> None:
        if degree.get(j, 0) > 2 and j != 0:
            seq_list.append(seq)
            seq = []
        if degree.get(j, 0) == 1:
            seq_list.append(seq)
            return
        for idx, e in enumerate(edges):
            if e[0] == j:
                find_seq(e[1], seq + [idx])

    find_seq(0, [])

    pooling_list: List[List[int]] = []
    new_edges: List[Edge] = []
    for seq in seq_list:
        if last_pool:
            pooling_list.append(seq)
            continue
        if len(seq) % 2 == 1:
            pooling_list.append([seq[0]])
            new_edges.append(tuple(edges[seq[0]]))
            seq = seq[1:]
        for i in range(0, len(seq), 2):
            pooling_list.append([seq[i], seq[i + 1]])
            new_edges.append((edges[seq[i]][0], edges[seq[i + 1]][1]))
    return seq_list, pooling_list, new_edges


def pooling_matrix(
    pooling_list: Sequence[Sequence[int]], in_edge_num: int, channels_per_edge: int
) -> np.ndarray:
    """Mean-pooling matrix ``(k_edges*c, n_edges*c)``."""
    sel = np.zeros((len(pooling_list), in_edge_num), dtype=np.float32)
    for i, group in enumerate(pooling_list):
        for j in group:
            sel[i, j] = 1.0 / len(group)
    return np.kron(sel, np.eye(channels_per_edge, dtype=np.float32))


def unpooling_matrix(
    pooling_list: Sequence[Sequence[int]], channels_per_edge: int
) -> np.ndarray:
    """Copy-back matrix ``(n_edges*c, k_edges*c)``: each pooled edge's
    channels go to all of its constituent edges."""
    out_edge_num = sum(len(p) for p in pooling_list)
    sel = np.zeros((out_edge_num, len(pooling_list)), dtype=np.float32)
    for i, group in enumerate(pooling_list):
        for j in group:
            sel[j, i] = 1.0
    return np.kron(sel, np.eye(channels_per_edge, dtype=np.float32))


def conv_channel_mask(
    neighbour_list: Sequence[Sequence[int]],
    in_channels_per_edge: int,
    out_channels_per_edge: int,
) -> np.ndarray:
    """0/1 mask ``(C_out, C_in)``: each edge's outputs see only neighbour
    inputs.  The kernel (time) axis is dense, so the mask broadcasts over K."""
    n = len(neighbour_list)
    sel = np.zeros((n, n), dtype=np.float32)
    for i, nbrs in enumerate(neighbour_list):
        sel[i, list(nbrs)] = 1.0
    return np.kron(
        sel, np.ones((out_channels_per_edge, in_channels_per_edge), dtype=np.float32)
    )


class SkeletonCascade:
    """Per-level topology of the whole pooling cascade (compared by identity)."""

    def __init__(self, parents: Sequence[int], num_layers: int, skeleton_dist: int):
        self.parents = tuple(parents)
        self.num_layers = num_layers
        self.skeleton_dist = skeleton_dist

        self.topologies: List[List[Edge]] = [edges_from_parents(self.parents)]
        self.neighbours: List[List[List[int]]] = []
        self.pooling_lists: List[List[List[int]]] = []
        self.edge_num: List[int] = [len(self.topologies[0])]
        for i in range(num_layers):
            edges = self.topologies[i]
            self.neighbours.append(neighbour_lists(edges, skeleton_dist))
            last = i == num_layers - 1
            _, pooling_list, new_edges = pool_edges(edges, last_pool=last)
            self.pooling_lists.append(pooling_list)
            self.topologies.append(new_edges)
            self.edge_num.append(len(pooling_list) if last else len(new_edges))
        # edge slots seen by the latent heads after each level's pool
        self.pooled_edge_num: List[int] = [len(pl) for pl in self.pooling_lists]

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other


@functools.lru_cache(maxsize=None)
def get_cascade(
    parents: Tuple[int, ...] = SMPL24_PARENTS,
    num_layers: int = 4,
    skeleton_dist: int = 2,
) -> SkeletonCascade:
    return SkeletonCascade(parents, num_layers, skeleton_dist)
