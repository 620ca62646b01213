"""MRL-like synthetic embedding corpus.

Matryoshka Representation Learning trains embeddings whose prefixes are
themselves good embeddings. We emulate the property the paper relies on
(prefix-truncations preserve neighborhoods) with a Gaussian-mixture corpus
whose cluster structure lives in the leading dimensions and whose energy
decays along the feature axis — prefix distances then correlate strongly
with full distances, exactly the regime where two-stage progressive search
keeps recall high."""
from __future__ import annotations

import numpy as np


def make_corpus(n: int, d_full: int, d_reduced: int, n_clusters: int = 64,
                decay: float = 8.0, noise: float = 0.10, seed: int = 0):
    """Returns (full [n, d_full] f32, reduced [n, d_reduced] f32,
    queries' generator-compatible params)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d_full)).astype(np.float32)
    # energy concentrates in leading dims (the MRL property)
    scale = np.exp(-decay * np.arange(d_full) / d_full).astype(np.float32)
    centers *= scale
    assign = rng.integers(0, n_clusters, n)
    pts = centers[assign] + noise * scale * rng.normal(
        size=(n, d_full)).astype(np.float32)
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    reduced = pts[:, :d_reduced].copy()
    return pts.astype(np.float32), reduced.astype(np.float32), assign


def make_queries(corpus: np.ndarray, n_q: int, jitter: float = 0.05,
                 seed: int = 1):
    """Queries near existing corpus points (realistic retrieval load)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, len(corpus), n_q)
    q = corpus[idx] + jitter * rng.normal(
        size=(n_q, corpus.shape[1])).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return q.astype(np.float32)
