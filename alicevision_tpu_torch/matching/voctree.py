"""Vocabulary-tree image retrieval: hierarchical k-means + TF-IDF scoring.

Port of `alicevision_tpu/matching/voctree.py` (ref:
src/aliceVision/voctree/VocabularyTree.hpp:102-131 quantizer,
SimpleKmeans.hpp / TreeBuilder.hpp training, Database.hpp:50-106,153
TF-IDF inverted file; used for pair selection by
src/software/pipeline/main_imageMatching.cpp:209). Tree traversal is a
per-level batched argmin against each level's centroid table; the
inverted-file scoring is a dense normalized BoW matrix product.

Random draws come from a `torch.Generator`. The reference pads every
node's training set to a power-of-two size so that one compiled k-means
serves all nodes; PyTorch runs eagerly, so each node trains on its own rows.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..numeric import f32_matmuls


class VocTree(NamedTuple):
    centers: torch.Tensor  # (n_levels, max_nodes, D) per-level centroids
    n_children: int
    n_levels: int

    @property
    def n_leaves(self) -> int:
        return self.n_children**self.n_levels


def _kmeans(generator, X, k, iters=10):
    """Plain k-means on (N, D); returns (k, D) centers."""
    return _kmeans_masked(generator, X, torch.ones(X.shape[0], dtype=torch.bool, device=X.device), k, iters)


@f32_matmuls
def _kmeans_masked(generator, X, valid, k, iters=10, idx=None):
    """Masked k-means on (N, D): invalid rows carry zero weight. The seeds
    are k rows drawn with replacement in proportion to the weights, from
    `generator` — or the given (k,) row indices `idx`."""
    w = valid.to(X.dtype)
    if idx is None:
        idx = torch.multinomial(w, k, replacement=True, generator=generator)
    centers = X[idx]
    for _ in range(iters):
        d = (
            torch.sum(X * X, -1, keepdim=True)
            - 2 * X @ centers.T
            + torch.sum(centers * centers, -1)[None, :]
        )
        assign = torch.argmin(d, -1)
        onehot = torch.nn.functional.one_hot(assign, k).to(X.dtype) * w[:, None]
        counts = onehot.sum(0)
        sums = onehot.T @ X
        centers = torch.where(counts[:, None] > 0, sums / counts[:, None].clamp(min=1), centers)
    return centers


def build_voctree(
    generator: torch.Generator,
    descriptors: torch.Tensor,  # (N, D) training descriptors
    n_children: int = 8,
    n_levels: int = 4,
    kmeans_iters: int = 8,
) -> VocTree:
    """Train the hierarchical vocabulary (TreeBuilder equivalent) on the
    descriptors' device; `generator` lives there too.

    Level l has n_children^(l+1) centroids stored flat; each node's children
    are trained on the descriptors assigned to that node. Host-side loop over
    nodes (training is offline), k-means on tensors inside.
    """
    dev = descriptors.device
    D = descriptors.shape[1]
    X = descriptors.detach().cpu().numpy().astype(np.float32)
    rng = np.random.RandomState(0)
    max_node_samples = 8192  # cap per-node training set (offline quality knob)
    assign = np.zeros(len(X), np.int64)  # node id at current level
    levels = []
    for l in range(n_levels):
        n_nodes = n_children ** (l + 1)
        centers_l = np.zeros((n_nodes, D), np.float32)
        for parent in range(n_children**l):
            sel = np.nonzero(assign == parent)[0]
            if len(sel) >= n_children:
                if len(sel) > max_node_samples:
                    sel = rng.choice(sel, max_node_samples, replace=False)
                c = _kmeans(generator, torch.from_numpy(X[sel]).to(dev), n_children, kmeans_iters)
                c = c.cpu().numpy()
            else:
                c = np.zeros((n_children, D), np.float32)
                if len(sel) > 0:
                    c[: len(sel)] = X[sel]
            centers_l[parent * n_children : (parent + 1) * n_children] = c
        # reassign
        child_of = np.zeros(len(X), np.int64)
        for parent in range(n_children**l):
            sel = np.nonzero(assign == parent)[0]
            if len(sel) == 0:
                continue
            c = centers_l[parent * n_children : (parent + 1) * n_children]
            d = ((X[sel][:, None, :] - c[None]) ** 2).sum(-1)
            child_of[sel] = parent * n_children + np.argmin(d, -1)
        assign = child_of
        levels.append(centers_l)

    max_nodes = n_children**n_levels
    stacked = np.zeros((n_levels, max_nodes, D), np.float32)
    for l, c in enumerate(levels):
        stacked[l, : len(c)] = c
    return VocTree(centers=torch.from_numpy(stacked).to(dev), n_children=n_children, n_levels=n_levels)


def quantize(tree: VocTree, desc: torch.Tensor) -> torch.Tensor:
    """Descriptors (N, D) -> leaf word ids (N,) by greedy tree descent
    (VocabularyTree::quantize)."""
    n = desc.shape[0]
    node = torch.zeros((n,), dtype=torch.int64, device=desc.device)
    children = torch.arange(tree.n_children, device=desc.device)
    for l in range(tree.n_levels):
        base = node * tree.n_children
        cand = base[:, None] + children[None, :]  # (N, C)
        c = tree.centers[l][cand]  # (N, C, D)
        d = torch.sum((desc[:, None, :] - c) ** 2, dim=-1)
        node = base + torch.argmin(d, dim=-1)
    return node.to(torch.int32)


def bow_vector(tree: VocTree, desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Raw term-frequency histogram over leaves (n_leaves,)."""
    words = quantize(tree, desc).to(torch.int64)
    w = valid.to(torch.float32)
    return torch.zeros((tree.n_leaves,), dtype=torch.float32, device=desc.device).index_add_(0, words, w)


class VocTreeDatabase(NamedTuple):
    """TF-IDF database over a set of images (Database.hpp equivalent)."""

    tfidf: torch.Tensor  # (n_images, n_leaves) L2-normalized tf-idf vectors
    idf: torch.Tensor  # (n_leaves,)


def build_database(tree: VocTree, bows: torch.Tensor) -> VocTreeDatabase:
    """bows: (n_images, n_leaves) raw counts -> tf-idf with L2 norm."""
    n_images = bows.shape[0]
    df = torch.sum(bows > 0, dim=0)  # document frequency
    # +0.5 smoothing keeps idf strictly positive even when every image
    # touches a leaf (df == N).
    idf = torch.log((n_images + 1.0) / (df + 0.5))
    tf = bows / torch.sum(bows, dim=1, keepdim=True).clamp(min=1.0)
    v = tf * idf[None, :]
    v = v / torch.linalg.norm(v, dim=1, keepdim=True).clamp(min=1e-12)
    return VocTreeDatabase(tfidf=v, idf=idf)


@f32_matmuls
def query_pairs(db: VocTreeDatabase, n_neighbors: int = 10) -> np.ndarray:
    """All-vs-all retrieval: for each image, its top-k most similar others.

    Returns (n_images * k, 2) unique candidate pairs — the pair list that
    feeds feature matching (ImageMatching method VOCTREE,
    ref: imageMatching/ImageMatching.hpp:50-58).
    """
    sim = db.tfidf @ db.tfidf.T  # (N, N) cosine similarity — one product
    n = sim.shape[0]
    sim = sim - 2.0 * torch.eye(n, dtype=sim.dtype, device=sim.device)  # exclude self
    k = min(n_neighbors, n - 1)
    _, nbrs = torch.topk(sim, k, dim=-1)
    nbrs = nbrs.cpu().numpy()
    pairs = set()
    for i in range(n):
        for j in nbrs[i]:
            a, b = (i, int(j)) if i < j else (int(j), i)
            if a != b:
                pairs.add((a, b))
    return np.array(sorted(pairs), np.int64).reshape(-1, 2)


def exhaustive_pairs(n: int) -> np.ndarray:
    """All N(N-1)/2 pairs (pairBuilder.cpp exhaustivePairs)."""
    out = [(i, j) for i in range(n) for j in range(i + 1, n)]
    return np.array(out, np.int64).reshape(-1, 2)


def sequential_pairs(n: int, window: int = 5) -> np.ndarray:
    """Video-style windowed pairs (ImageMatching SEQUENTIAL)."""
    out = [(i, j) for i in range(n) for j in range(i + 1, min(i + 1 + window, n))]
    return np.array(out, np.int64).reshape(-1, 2)
