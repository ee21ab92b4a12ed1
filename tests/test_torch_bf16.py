"""bf16 decode against forward, in the JAX reference and in the port (CPU).

Step-by-step decode and one forward compute the same function; in bf16
each rounds in its own places, so their logits differ. How much depends on
the model and grows with depth: at ``reduced`` size (a few layers) the
two models differ alike, but at full depth and a narrow width (d_model
256, vocab 1024, otherwise ``reduced``) the JAX reference's xlstm-350m
differs many times more than its smollm-360m, and by more than smollm's
limit of 5e-2, so the excess is the model's and not the port's. ``chip_smoke.py`` holds the
full-width models on the card to the limits in ``LIMIT``. Parameters come
from JAX ``init_model`` through ``params_from_jax``; ``pytest -s`` prints
the readings.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import model as JM
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.models import model as M

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

B, S = 2, 64
LIMIT = {"smollm_360m": 5e-2, "xlstm_350m": 0.15}   # chip_smoke.py, bf16


def shape(get, shrink, arch, depth):
    """``arch`` reduced in bf16; at ``depth="full"`` with all its layers,
    d_model 256 and vocab 1024."""
    cfg = dataclasses.replace(shrink(get(arch)), dtype="bfloat16")
    if depth == "full":
        cfg = dataclasses.replace(cfg, n_layers=get(arch).n_layers, d_model=256, vocab=1024)
    return cfg


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@functools.cache
def readings(arch, depth):
    """(JAX, port) relative max error of bf16 step-by-step decode logits
    against one bf16 forward over ``S`` positions, same weights and tokens."""
    jcfg = shape(jax_get_config, jax_reduced, arch, depth)
    tcfg = shape(get_config, reduced, arch, depth)
    jparams, _ = JM.init_model(jax.random.PRNGKey(1), jcfg)
    tokens = np.random.default_rng(8).integers(0, jcfg.vocab, (B, S), dtype=np.int32)

    full = np.asarray(jax.jit(JM.forward, static_argnums=1)(jparams, jcfg,
                                                             jnp.asarray(tokens)), np.float32)
    dec = jax.jit(JM.decode_step, static_argnums=1)
    cache, steps = JM.init_cache(jcfg, B, S), []
    for t in range(S):
        lg, cache = dec(jparams, jcfg, cache, jnp.asarray(tokens[:, t]), t)
        steps.append(np.asarray(lg, np.float32))
    jax_err = rel_err(np.stack(steps, axis=1), full)

    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    toks = torch.from_numpy(tokens).long()
    full = M.forward(tparams, tcfg, toks).float().numpy()
    cache, steps = M.init_cache(tcfg, B, S, device="cpu"), []
    for t in range(S):
        lg, cache = M.decode_step(tparams, tcfg, cache, toks[:, t], t)
        steps.append(lg.float().numpy())
    port_err = rel_err(np.stack(steps, axis=1), full)
    print(f"\n{arch} bf16 decode vs forward, {jcfg.n_layers} layers, "
          f"d_model {jcfg.d_model}: "
          f"JAX {jax_err:.4g}, port {port_err:.4g}")
    return jax_err, port_err


@pytest.mark.parametrize("depth", ["reduced", "full"])
@pytest.mark.parametrize("arch", ["smollm_360m", "xlstm_350m"])
def test_bf16_decode_vs_forward_within_the_card_limit(arch, depth):
    jax_err, port_err = readings(arch, depth)
    assert jax_err < LIMIT[arch] and port_err < LIMIT[arch], (jax_err, port_err)


def test_jax_xlstm_amplifies_bf16_rounding():
    """The reference itself: xLSTM's bf16 decode-vs-forward error is many
    times smollm's and above smollm's limit."""
    xlstm, smollm = readings("xlstm_350m", "full")[0], readings("smollm_360m", "full")[0]
    assert xlstm > 5 * smollm and xlstm > LIMIT["smollm_360m"], (xlstm, smollm)
