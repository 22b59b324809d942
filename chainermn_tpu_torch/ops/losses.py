"""Loss and metric ops (port of ``chainermn_tpu/ops/losses.py``).

Logits may arrive in bf16; the log-sum-exp accumulates in fp32, as in
the JAX package.
"""

from __future__ import annotations

import torch


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                          z_loss: float = 0.0) -> torch.Tensor:
    """Mean cross-entropy for integer labels, fp32 accumulation.

    ``z_loss`` adds the PaLM-style log-normalizer penalty
    (``z_loss * logZ^2``)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    loss = logz - ll
    if z_loss:
        loss = loss + z_loss * torch.square(logz)
    return loss.mean()


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Share of rows whose argmax is the label, as an fp32 scalar."""
    return (logits.argmax(dim=-1) == labels).float().mean()
