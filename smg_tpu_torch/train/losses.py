"""Training losses (port of smg_tpu/train/losses.py).

- reactive: 3-class cross-entropy with class 2 ('no loss') weighted 0
  (reference trainer.py:34-60, NLLLoss on log_softmax);
- reinforcement: the reference's smooth-L1 on the scalar Q
  (trainer.py:344-380): 0.5 d^2 for |d| < 1, else |d| - 0.5.
"""

from __future__ import annotations

import torch

REACTIVE_CLASS_WEIGHTS = (1.0, 1.0, 0.0)


def reactive_ce(logits: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Weighted CE: logits (..., 3), integer label (...,) -> loss (...,)."""
    logp = torch.log_softmax(logits, dim=-1)
    label = label.long()
    picked = torch.gather(logp, -1, label[..., None])[..., 0]
    w = torch.tensor(REACTIVE_CLASS_WEIGHTS, device=logits.device)[label]
    return -w * picked


def huber_q(q: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Reference smooth-L1, elementwise."""
    d = (q - label).abs()
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)
