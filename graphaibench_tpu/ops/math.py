"""Elementwise / reduction math matching reference semantics.

Counterparts of src/utilities/math_functions.cpp. Dense GEMMs are plain
jnp.dot; only the ops whose exact semantics matter for
parity are spelled out here (cross-entropy epsilon clamps, masked
accuracy, dropout scaling).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def leaky_relu(x: jnp.ndarray, epsilon: float = 0.2) -> jnp.ndarray:
    # math_functions.cpp:465-467
    return jnp.where(x > 0, x, epsilon * x)


def cross_entropy(y: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """Row-wise CE with the reference's clamp: p==0 contributes
    -y*log(1e-10) (math_functions.cpp:532-543). y is one/multi-hot."""
    logp = jnp.log(jnp.where(p == 0.0, 1e-10, p))
    return -jnp.sum(y * logp, axis=-1)


def sigmoid_cross_entropy_with_logits(y: jnp.ndarray, logits: jnp.ndarray) -> jnp.ndarray:
    """Per-element numerically-stable sigmoid CE
    (math_functions.cpp:553-559, the TF formulation)."""
    zeros = jnp.zeros_like(logits)
    return jnp.maximum(logits, zeros) - logits * y + jnp.log1p(jnp.exp(-jnp.abs(logits)))


def dropout(key: jax.Array, x: jnp.ndarray, rate: float) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Reference dropout (dropout_cpu, math_functions.cpp:413-425):
    keep with prob 1-rate, scale kept values by 1/(1-rate). Returns
    (out, mask) — the mask is reused by the backward pass."""
    keep = jax.random.bernoulli(key, 1.0 - rate, x.shape)
    scale = 1.0 / (1.0 - rate)
    return jnp.where(keep, x * scale, 0.0), keep


def masked_accuracy_single(
    preds: jnp.ndarray, labels: jnp.ndarray, mask: jnp.ndarray
) -> jnp.ndarray:
    """Fraction of masked vertices whose argmax matches the label
    (masked_accuracy_single, math_functions.cpp:79-92)."""
    correct = (jnp.argmax(preds, axis=-1) == labels) & (mask != 0)
    n = jnp.maximum(jnp.sum(mask != 0), 1)
    return jnp.sum(correct) / n


def masked_f1_micro(
    probs: jnp.ndarray, labels: jnp.ndarray, mask: jnp.ndarray, threshold: float = 0.5
) -> jnp.ndarray:
    """Micro-F1 over masked vertices for multi-label tasks
    (masked_f1_score / masked_accuracy_multi, math_functions.cpp:94-97)."""
    m = (mask != 0)[:, None]
    pred = (probs > threshold) & m
    true = (labels != 0) & m
    tp = jnp.sum(pred & true)
    fp = jnp.sum(pred & ~true)
    fn = jnp.sum(~pred & true)
    precision = tp / jnp.maximum(tp + fp, 1)
    recall = tp / jnp.maximum(tp + fn, 1)
    return 2 * precision * recall / jnp.maximum(precision + recall, 1e-10)


def l2norm_rows(x: jnp.ndarray, eps: float = 1e-12) -> jnp.ndarray:
    """Row-wise L2 normalization. The squared-sum is clamped at 1e-12
    *before* the sqrt, exactly like l2norm_layer.cpp:19-38."""
    sum_x2 = jnp.maximum(jnp.sum(x * x, axis=-1, keepdims=True), eps)
    return x / jnp.sqrt(sum_x2)
