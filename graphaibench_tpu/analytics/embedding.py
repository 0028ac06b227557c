"""Random-walk vertex embeddings: DeepWalk and node2vec.

The reference lists these as planned-but-absent ("TODO: node2vec,
deepwalk", src/embedding/README.md:50-54 cites external implementations);
here they are real. Device formulation: walks are generated with the
vectorized device walker (analytics/khop.py), and skip-gram with negative
sampling trains as dense batched matmuls — every step is a pair of
embedding-row gathers, a batched dot product, and a scatter-add update,
so the hot loop is one jitted Adam step over (B, dim) tensors.

node2vec biases the walk with the standard p/q second-order rule
(return parameter p, in-out parameter q); the bias only needs membership
of the candidate in N(prev), answered with the same batched sorted
searchsorted used by the triangle counter.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np

from graphaibench_tpu.graph.csr import CSRGraph


from graphaibench_tpu.analytics.khop import _padded_nbrs  # shared packing


def node2vec_walks(g: CSRGraph, starts: np.ndarray, walk_length: int, *,
                   p: float = 1.0, q: float = 1.0, seed: int = 0) -> np.ndarray:
    """(num_walks, walk_length+1) second-order biased walks.

    Transition weights from v (having arrived from t): 1/p back to t,
    1 to common neighbors of t and v, 1/q otherwise — sampled by
    rejection on the padded neighbor row (all vectorized over walks).
    """
    nbr_h, deg_h = _padded_nbrs(g)
    sentinel = g.nv + 1
    # sentinel-padded sorted adjacency for membership tests (adjacency
    # lists are stored sorted; padding slots get an id above every vertex)
    W = nbr_h.shape[1]
    pad_mask = np.arange(W, dtype=np.int64)[None, :] >= np.asarray(deg_h)[:, None]
    # device-resident walk tables, passed as jit ARGUMENTS (closed-over
    # arrays become constants embedded in the compiled program)
    sorted_nbr_d = jnp.asarray(
        np.where(pad_mask, sentinel, np.asarray(nbr_h)).astype(np.int32))
    nbr_d = jnp.asarray(nbr_h)
    deg_d = jnp.asarray(deg_h)
    key = jax.random.PRNGKey(seed)
    cur = jnp.asarray(np.asarray(starts, dtype=np.int32))
    prev = cur  # no history on the first hop -> uniform
    w_max = max(1.0, 1.0 / p, 1.0 / q)

    @jax.jit
    def step(prev, cur, key, nbr, deg, sorted_nbr):
        k1, k2 = jax.random.split(key)
        # up to 8 rejection rounds, batched over all walks
        def body(i, state):
            prv, c, accepted, out, k = state
            k, ka, kb = jax.random.split(k, 3)
            r = jax.random.randint(ka, c.shape, 0, jnp.maximum(deg[c], 1))
            cand = nbr[c, r]
            # bias: 1/p if cand == prev; 1 if cand in N(prev); else 1/q
            row = sorted_nbr[prv]
            idx = jax.vmap(jnp.searchsorted)(row, cand)
            idx = jnp.minimum(idx, W - 1)
            in_prev = jnp.take_along_axis(row, idx[:, None], 1)[:, 0] == cand
            wgt = jnp.where(cand == prv, 1.0 / p,
                            jnp.where(in_prev, 1.0, 1.0 / q))
            ok = (jax.random.uniform(kb, c.shape) * w_max <= wgt) & ~accepted
            out = jnp.where(ok, cand, out)
            return prv, c, accepted | ok, out, k
        # fallback = unbiased candidate (accepted stays False -> use it)
        k0, k1 = jax.random.split(k1)
        r0 = jax.random.randint(k0, cur.shape, 0, jnp.maximum(deg[cur], 1))
        fallback = nbr[cur, r0]
        _, _, acc, nxt, _ = jax.lax.fori_loop(
            0, 8, body, (prev, cur, jnp.zeros(cur.shape, bool), fallback, k2))
        nxt = jnp.where(deg[cur] > 0, nxt, cur)
        return nxt

    walks = [cur]
    for _ in range(walk_length):
        key, sub = jax.random.split(key)
        nxt = step(prev, cur, sub, nbr_d, deg_d, sorted_nbr_d)
        prev, cur = cur, nxt
        walks.append(cur)
    return np.asarray(jnp.stack(walks, axis=1))


def _skipgram_pairs(walks: np.ndarray, window: int) -> tuple[np.ndarray, np.ndarray]:
    """All (center, context) pairs within +-window along each walk."""
    centers, contexts = [], []
    L = walks.shape[1]
    for off in range(1, window + 1):
        if off >= L:
            break
        centers.append(walks[:, :-off].ravel())
        contexts.append(walks[:, off:].ravel())
        centers.append(walks[:, off:].ravel())
        contexts.append(walks[:, :-off].ravel())
    return (np.concatenate(centers).astype(np.int32),
            np.concatenate(contexts).astype(np.int32))


def train_skipgram(nv: int, centers: np.ndarray, contexts: np.ndarray, *,
                   dim: int = 64, epochs: int = 3, neg: int = 5,
                   lr: float = 0.025, batch: int = 65536,
                   seed: int = 0) -> np.ndarray:
    """Skip-gram with negative sampling as batched device matmuls.

    loss = -log sig(u_c . v_o) - sum_neg log sig(-u_c . v_n); one jitted
    SGD step per batch (gather rows, batched dots, scatter-add grads).
    Returns the (nv, dim) input embedding matrix.
    """
    rng = np.random.default_rng(seed)
    u = jnp.asarray((rng.random((nv, dim)) - 0.5).astype(np.float32) / dim)
    v = jnp.asarray(np.zeros((nv, dim), dtype=np.float32))
    n_pairs = len(centers)
    # scatter-add sums every duplicate index's gradient at full lr, so a
    # batch must not contain many pairs per vertex (tiny graphs would
    # diverge); ~8 appearances per vertex per step is safe
    batch = max(256, min(batch, n_pairs, 8 * nv))
    order = rng.permutation(n_pairs)
    padded = ((n_pairs + batch - 1) // batch) * batch
    centers = np.resize(centers[order], padded)
    contexts = np.resize(contexts[order], padded)

    @jax.jit
    def step(u, v, c, o, negs, lr_t):
        uc = u[c]                                  # (B, D)
        vo = v[o]                                  # (B, D)
        vn = v[negs]                               # (B, K, D)
        s_pos = jax.nn.sigmoid(jnp.einsum("bd,bd->b", uc, vo))
        s_neg = jax.nn.sigmoid(jnp.einsum("bd,bkd->bk", uc, vn))
        g_pos = (s_pos - 1.0)[:, None]             # dL/d(u.v)
        g_neg = s_neg                              # (B, K)
        du = g_pos * vo + jnp.einsum("bk,bkd->bd", g_neg, vn)
        dvo = g_pos * uc
        dvn = g_neg[..., None] * uc[:, None, :]
        u = u.at[c].add(-lr_t * du)
        v = v.at[o].add(-lr_t * dvo)
        v = v.at[negs.reshape(-1)].add(-lr_t * dvn.reshape(-1, u.shape[1]))
        loss = -jnp.mean(jnp.log(s_pos + 1e-9) +
                         jnp.sum(jnp.log(1 - s_neg + 1e-9), axis=1))
        return u, v, loss

    total = len(centers)
    steps_per_epoch = total // batch
    t = 0
    for ep in range(epochs):
        key = jax.random.PRNGKey(seed + ep)
        for s in range(steps_per_epoch):
            lo = s * batch
            c = jnp.asarray(centers[lo:lo + batch])
            o = jnp.asarray(contexts[lo:lo + batch])
            key, sub = jax.random.split(key)
            negs = jax.random.randint(sub, (batch, neg), 0, nv)
            lr_t = lr * max(1e-4, 1 - t / (epochs * steps_per_epoch))
            u, v, _ = step(u, v, c, o, negs, lr_t)
            t += 1
    return np.asarray(u)


def deepwalk(g: CSRGraph, *, dim: int = 64, walks_per_vertex: int = 10,
             walk_length: int = 20, window: int = 5, epochs: int = 3,
             neg: int = 5, lr: float = 0.025, seed: int = 0) -> np.ndarray:
    """DeepWalk (Perozzi et al.): uniform walks + skip-gram."""
    from graphaibench_tpu.analytics.khop import random_walk

    starts = np.tile(np.arange(g.nv, dtype=np.int32), walks_per_vertex)
    walks = random_walk(g, starts, walk_length, seed=seed)
    c, o = _skipgram_pairs(walks, window)
    return train_skipgram(g.nv, c, o, dim=dim, epochs=epochs, neg=neg,
                          lr=lr, seed=seed)


def node2vec(g: CSRGraph, *, dim: int = 64, walks_per_vertex: int = 10,
             walk_length: int = 20, window: int = 5, p: float = 1.0,
             q: float = 1.0, epochs: int = 3, neg: int = 5,
             lr: float = 0.025, seed: int = 0) -> np.ndarray:
    """node2vec (Grover & Leskovec): p/q-biased walks + skip-gram."""
    starts = np.tile(np.arange(g.nv, dtype=np.int32), walks_per_vertex)
    walks = node2vec_walks(g, starts, walk_length, p=p, q=q, seed=seed)
    c, o = _skipgram_pairs(walks, window)
    return train_skipgram(g.nv, c, o, dim=dim, epochs=epochs, neg=neg,
                          lr=lr, seed=seed)
