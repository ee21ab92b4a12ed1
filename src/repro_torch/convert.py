"""Parameters of the JAX reference model, as numpy, into the port's.

``repro.models.model.init_model`` returns a pytree of dictionaries and
lists whose decoder blocks are stacked over ``n_repeats`` (one entry per
pattern position), with weights stored ``(in, out)`` and applied as
``x @ W``. The port keeps that layout, so conversion is leaf by leaf:
numpy (float32, or ml_dtypes bfloat16) to a torch tensor of the same
dtype and shape. ``opt_state_from_jax`` does the same for the reference's
AdamW state. This module takes numpy and never imports JAX.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Params, resolve_device
from repro_torch.models.model import MAX_ABS_POS, check_supported


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


def _leaves(tree: Params, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def params_from_jax(tree: Params, cfg: ModelConfig, *,
                    device: str | torch.device = "cuda") -> Params:
    """The reference's params (leaves as numpy) -> the port's params on
    ``device``. Checks the embedding, and that every leaf of every block
    stack has ``n_repeats`` along its leading axis, against ``cfg``; for the
    encoder-decoder also that every leaf of ``enc_blocks`` has
    ``n_enc_layers`` along its leading axis, that ``dec_pos`` is
    (MAX_ABS_POS, d_model), and that the decoder blocks carry ``cross`` and
    ``cross_norm`` exactly when ``cfg.enc_dec``."""
    check_supported(cfg)
    p = _convert(tree, resolve_device(device))
    if tuple(p["embed"].shape) != (cfg.vocab, cfg.d_model):
        raise ValueError(f"embed {tuple(p['embed'].shape)} != {(cfg.vocab, cfg.d_model)}")
    if len(p["blocks"]) != cfg.pattern_period:
        raise ValueError(f"{len(p['blocks'])} block stacks, pattern period "
                         f"{cfg.pattern_period}")
    stacks = [(f"block stack {i}", block, "n_repeats", cfg.n_repeats)
              for i, block in enumerate(p["blocks"])]
    if cfg.enc_dec:
        missing = {"enc_blocks", "enc_norm", "dec_pos"} - set(p)
        if missing:
            raise ValueError(f"encoder-decoder params lack {sorted(missing)}")
        stacks.append(("enc_blocks", p["enc_blocks"], "n_enc_layers", cfg.n_enc_layers))
        if tuple(p["dec_pos"].shape) != (MAX_ABS_POS, cfg.d_model):
            raise ValueError(f"dec_pos {tuple(p['dec_pos'].shape)} != "
                             f"{(MAX_ABS_POS, cfg.d_model)}")
    for i, block in enumerate(p["blocks"]):
        cross = sorted({"cross", "cross_norm"} & set(block))
        if cross != (["cross", "cross_norm"] if cfg.enc_dec else []):
            raise ValueError(f"block stack {i} has {cross} with enc_dec={cfg.enc_dec}")
    for where, block, axis, n in stacks:
        for name, leaf in _leaves(block):
            if leaf.dim() == 0 or leaf.shape[0] != n:
                raise ValueError(f"{where} leaf {name} {tuple(leaf.shape)} is not "
                                 f"stacked over {axis} {n}")
    if cfg.tie_embeddings == ("lm_head" in p):
        raise ValueError(f"tie_embeddings={cfg.tie_embeddings} but lm_head "
                         f"{'present' if 'lm_head' in p else 'absent'}")
    return p


def opt_state_from_jax(tree: dict[str, Any], *,
                       device: str | torch.device = "cuda") -> dict[str, Any]:
    """The reference's AdamW state ``{"mu", "nu", "count"}`` (leaves as
    numpy) -> the port's on ``device``: fp32 moments, ``count`` a 0-d int32
    tensor."""
    if set(tree) != {"mu", "nu", "count"}:
        raise ValueError(f"AdamW state keys {sorted(tree)}, expected count, mu, nu")
    dev = resolve_device(device)
    count = torch.tensor(int(np.asarray(tree["count"])), dtype=torch.int32, device=dev)
    return {"mu": _convert(tree["mu"], dev), "nu": _convert(tree["nu"], dev), "count": count}
