"""Parameters of the JAX reference model, as numpy, into the port's.

``repro.models.model.init_model`` returns a pytree of dictionaries and
lists whose decoder blocks are stacked over ``n_repeats`` (one entry per
pattern position), with weights stored ``(in, out)`` and applied as
``x @ W``. The port keeps that layout, so conversion is leaf by leaf:
numpy (float32, or ml_dtypes bfloat16) to a torch tensor of the same
dtype and shape. This module takes numpy and never imports JAX.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Params, resolve_device
from repro_torch.models.model import check_supported


def _tensor(a: Any, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes: torch reads the bits
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _convert(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_convert(v, device) for v in tree]
    return _tensor(tree, device)


def params_from_jax(tree: Params, cfg: ModelConfig, *,
                    device: str | torch.device = "cuda") -> Params:
    """The reference's params (leaves as numpy) -> the port's params on
    ``device``. Checks the embedding and the stacking against ``cfg``."""
    check_supported(cfg)
    p = _convert(tree, resolve_device(device))
    if tuple(p["embed"].shape) != (cfg.vocab, cfg.d_model):
        raise ValueError(f"embed {tuple(p['embed'].shape)} != {(cfg.vocab, cfg.d_model)}")
    if len(p["blocks"]) != cfg.pattern_period:
        raise ValueError(f"{len(p['blocks'])} block stacks, pattern period "
                         f"{cfg.pattern_period}")
    for block in p["blocks"]:
        lead = block["mixer"]["wq"].shape[0]
        if lead != cfg.n_repeats:
            raise ValueError(f"blocks stacked over {lead}, n_repeats {cfg.n_repeats}")
    if cfg.tie_embeddings == ("lm_head" in p):
        raise ValueError(f"tie_embeddings={cfg.tie_embeddings} but lm_head "
                         f"{'present' if 'lm_head' in p else 'absent'}")
    return p
