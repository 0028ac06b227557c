"""Collaborative filtering: latent-factor matrix completion.

Same update rule as the reference's gather-apply two-phase SGD
(src/embedding/omp_base.cc:15-77, defaults main.cc:6-10: K=20,
lambda=0.001, step=3.5e-7, max_iters=5): per iteration every vertex
accumulates err[u] = sum over ratings (r_uv - <p_u, p_v>) * p_v, then
p_u += step * (-lambda * p_u + err[u]). Here the per-edge estimate is
an SDDMM and the accumulation a segment-sum."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from graphaibench_tpu.graph.csr import CSRGraph
from graphaibench_tpu.ops.device_graph import to_device_graph
from graphaibench_tpu.ops.rng import uniform_reference

K = 20          # latent dimension (common.h:85)
LAMBDA = 0.001
STEP = 0.00000035
MAX_ITERS = 5
CF_EPSILON = 0.1


def init_latents(nv: int, k: int = K) -> np.ndarray:
    """The reference reseeds default_random_engine() per vertex
    (main.cc:15-30) so every row is identical; reproduce that quirk."""
    row = uniform_reference(1, k, 0.0, 1.0)  # default-constructed == seed 1
    return np.tile(row, (nv, 1)).astype(np.float32)


def cf_train(
    g: CSRGraph,
    ratings: np.ndarray,
    *,
    k: int = K,
    lam: float = LAMBDA,
    step: float = STEP,
    max_iters: int = MAX_ITERS,
    epsilon: float = CF_EPSILON,
    latents: np.ndarray | None = None,
):
    """Returns (latents, rmse_history). ``g`` is the bipartite graph with
    edges stored in both directions; ``ratings`` per edge in CSR order."""
    dg = to_device_graph(g, with_transpose=False, with_ell=False)
    r = jnp.asarray(np.asarray(ratings, dtype=np.float32))
    lat0 = jnp.asarray(latents if latents is not None else init_latents(g.nv, k))
    src, dst = dg.edge_src, dg.col_idx

    @jax.jit
    def one_iter(lat):
        est = jnp.einsum("ek,ek->e", lat[src], lat[dst])
        delta = r - est
        err = jax.ops.segment_sum(delta[:, None] * lat[dst], src,
                                  num_segments=dg.nv)
        new = lat + step * (-lam * lat + err)
        rmse = jnp.sqrt(jnp.sum(delta * delta) / dg.ne)
        return new, rmse

    lat = lat0
    history = []
    for _ in range(max_iters):
        lat, rmse = one_iter(lat)
        history.append(float(rmse))
        if history[-1] < epsilon:
            break
    return np.asarray(lat), history
