"""Nearest-neighbor search over vertex embeddings.

The reference's ANN benchmark (src/nearest_neighbor_search/ann.h:5-24)
builds random embeddings and answers queries; its solvers are stubs. The
version here is a real brute-force exact kNN: one (Q, D) x (D, N) matmul
+ top-k — the dense formulation."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def knn_search(
    embeddings: np.ndarray,  # (N, D)
    queries: np.ndarray,     # (Q, D)
    k: int = 10,
    *,
    metric: str = "l2",
):
    """Returns (indices (Q, k), scores (Q, k))."""
    x = jnp.asarray(embeddings)
    q = jnp.asarray(queries)

    @jax.jit
    def run(x, q):
        if metric == "ip":
            scores = q @ x.T
        elif metric == "cos":
            xn = x / jnp.linalg.norm(x, axis=1, keepdims=True).clip(1e-12)
            qn = q / jnp.linalg.norm(q, axis=1, keepdims=True).clip(1e-12)
            scores = qn @ xn.T
        else:  # negative squared L2 via the matmul expansion
            scores = 2.0 * (q @ x.T) - jnp.sum(x * x, axis=1)[None, :]
        return jax.lax.top_k(scores, k)

    scores, idx = run(x, q)
    return np.asarray(idx), np.asarray(scores)
