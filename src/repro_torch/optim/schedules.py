"""Learning-rate schedules."""
from __future__ import annotations

import math

import torch


def cosine_schedule(step, *, warmup: int = 200, total: int = 10000,
                    min_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_frac``; a 0-d fp32 tensor on
    ``step``'s device (an int, or a tensor such as the optimizer's count)."""
    step = torch.as_tensor(step).float()
    # step 0 is the FIRST step: lr must be nonzero ((step+1)/warmup)
    warm = (step + 1.0) / max(1.0, warmup)
    prog = torch.clamp((step - warmup) / max(1.0, total - warmup), 0, 1)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < warmup, warm, cos)
