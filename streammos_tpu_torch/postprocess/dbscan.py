"""DBSCAN on scipy, with the labels of scikit-learn's
``DBSCAN(eps, min_samples).fit_predict`` (euclidean metric, no sample
weights), which the port does not depend on.

- Neighbours are the pairs at distance <= eps (`cKDTree.query_pairs`);
  scikit-learn's radius neighbours include the boundary too.
- A point counts itself towards ``min_samples``; a point with at least
  that many neighbours is a core point.
- Core points joined by core-core neighbour pairs form the clusters
  (`connected_components`).
- A border point (not core, a core neighbour) joins one cluster that reaches
  it: the one whose lowest core index is smallest. scikit-learn expands
  clusters in index order (``dbscan_inner``), and the first to reach a
  border point keeps it.
- Clusters are numbered in that same order; noise is -1.
"""
from __future__ import annotations

import numpy as np


def dbscan(points: np.ndarray, eps: float, min_samples: int) -> np.ndarray:
    """(N, D) points -> (N,) int64 cluster labels, -1 for noise."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components
    from scipy.spatial import cKDTree

    x = np.asarray(points, dtype=np.float64)
    n = x.shape[0]
    labels = np.full(n, -1, np.int64)
    if n == 0:
        return labels
    pairs = cKDTree(x).query_pairs(eps, output_type="ndarray")
    core = np.bincount(pairs.ravel(), minlength=n) + 1 >= min_samples
    core_idx = np.flatnonzero(core)
    if core_idx.size == 0:
        return labels

    both = core[pairs[:, 0]] & core[pairs[:, 1]]
    cc = pairs[both]
    graph = coo_matrix((np.ones(len(cc), np.int8), (cc[:, 0], cc[:, 1])),
                       shape=(n, n))
    _, comp = connected_components(graph, directed=False)
    # number the components that hold core points by their lowest core index
    first = np.full(comp.max() + 1, n, np.int64)
    np.minimum.at(first, comp[core_idx], core_idx)
    order = np.argsort(first, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(order.size)
    labels[core_idx] = rank[comp[core_idx]]

    # border points: the smallest cluster label among their core neighbours
    # (labels rise with the clusters' lowest core indices)
    one = pairs[core[pairs[:, 0]] != core[pairs[:, 1]]]
    if one.size:
        src = np.where(core[one[:, 0]], one[:, 0], one[:, 1])
        dst = np.where(core[one[:, 0]], one[:, 1], one[:, 0])
        best = np.full(n, np.iinfo(np.int64).max, np.int64)
        np.minimum.at(best, dst, labels[src])
        border = best != np.iinfo(np.int64).max
        labels[border] = best[border]
    return labels
