"""The port's model against the JAX reference on reduced configs (f32).

Parameters come from JAX ``init_model`` (never from re-seeding torch),
go through numpy into ``repro_torch.convert.params_from_jax``, and both
models see the same numpy tokens. Tolerances: forward relative max error
1e-4; step-by-step decode logits and cache 1e-4 relative; decode against
forward 1e-3 (tests/test_models.py). On the CPU the port's attention runs
the plain versions of its kernels.
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

ARCHS = ["smollm_360m", "llama3_405b", "qwen2_72b", "nemotron_4_340b", "chameleon_34b",
         "smollm_360m_g3", "smollm_360m_window8"]
B, S = 2, 16


def configs(arch):
    """(JAX config, port config) of one reduced case."""
    base = arch.split("_g3")[0].split("_window8")[0]
    jcfg, tcfg = jax_reduced(jax_get_config(base)), reduced(get_config(base))
    if arch.endswith("_g3"):        # smollm's 3 query heads per kv head
        jcfg = dataclasses.replace(jcfg, n_heads=6, n_kv_heads=2)
        tcfg = dataclasses.replace(tcfg, n_heads=6, n_kv_heads=2)
    if arch.endswith("_window8"):   # rotating cache once pos >= 8
        jcfg = dataclasses.replace(jcfg, sliding_window=8)
        tcfg = dataclasses.replace(tcfg, sliding_window=8)
    return jcfg, tcfg


@functools.cache
def case(arch):
    """JAX params and jitted functions, and the port's converted params;
    built once per arch and shared by this module's tests."""
    jcfg, tcfg = configs(arch)
    jparams, _ = JM.init_model(jax.random.PRNGKey(1), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    if jcfg.qkv_bias:  # the reference inits biases at zero: make them count
        rng = np.random.default_rng(7)
        for blk in tree["blocks"]:
            for name in ("bq", "bk", "bv"):
                blk["mixer"][name] = rng.standard_normal(
                    blk["mixer"][name].shape, dtype=np.float32) * 0.1
        jparams = jax.tree.map(jnp.asarray, tree)
    tokens = np.random.default_rng(8).integers(0, jcfg.vocab, (B, S), dtype=np.int32)
    fwd = jax.jit(JM.forward, static_argnums=1)
    dec = jax.jit(JM.decode_step, static_argnums=1)
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tokens=tokens,
                tparams=params_from_jax(tree, tcfg, device="cpu"),
                jfull=np.asarray(fwd(jparams, jcfg, jnp.asarray(tokens))), dec=dec)


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def port_decode_all(c):
    cache = M.init_cache(c["tcfg"], B, S, device="cpu")
    outs = []
    for t in range(S):
        lg, cache = M.decode_step(c["tparams"], c["tcfg"], cache,
                                  torch.from_numpy(c["tokens"][:, t]), t)
        outs.append(lg.numpy())
    return np.stack(outs, axis=1), cache


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    c = case(arch)
    out = M.forward(c["tparams"], c["tcfg"], torch.from_numpy(c["tokens"]))
    assert out.shape == (B, S, c["tcfg"].vocab) and out.dtype == torch.float32
    assert rel_err(out.numpy(), c["jfull"]) <= 1e-4


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_jax_step_by_step(arch):
    c = case(arch)
    jcache = JM.init_cache(c["jcfg"], B, S)
    tcache = M.init_cache(c["tcfg"], B, S, device="cpu")
    for t in range(S):
        jl, jcache = c["dec"](c["jparams"], c["jcfg"], jcache,
                              jnp.asarray(c["tokens"][:, t]), jnp.int32(t))
        tl, tcache = M.decode_step(c["tparams"], c["tcfg"], tcache,
                                   torch.from_numpy(c["tokens"][:, t]), t)
        assert rel_err(tl.numpy(), jl) <= 1e-4, t
        for jc, tc in zip(jcache, tcache):
            for name in ("k", "v"):
                assert rel_err(tc[name].numpy(), jc[name]) <= 1e-4, (t, name)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    c = case(arch)
    dec, _ = port_decode_all(c)
    full = M.forward(c["tparams"], c["tcfg"], torch.from_numpy(c["tokens"])).numpy()
    assert rel_err(dec, full) < 1e-3


def test_window8_cache_rotates():
    c = case("smollm_360m_window8")
    _, cache = port_decode_all(c)
    assert cache[0]["k"].shape[2] == 8  # bounded by the window, not by S = 16


def test_init_model_scales_and_layout():
    tcfg = reduced(get_config("qwen2_72b"))
    p = M.init_model(tcfg, seed=3, device="cpu")
    jp, _ = JM.init_model(jax.random.PRNGKey(0), jax_reduced(jax_get_config("qwen2_72b")))
    flat_t = {k: v for k, v in _flatten(p)}
    flat_j = {k: np.asarray(v) for k, v in _flatten(jax.tree.map(np.asarray, jp))}
    assert flat_t.keys() == flat_j.keys()
    for k, v in flat_t.items():
        assert tuple(v.shape) == flat_j[k].shape, k
        # same scale: standard deviations agree within sampling noise
        sj, st = float(np.std(flat_j[k])), float(v.float().std())
        assert abs(st - sj) <= 0.1 * sj + 1e-6, (k, st, sj)
    again = M.init_model(tcfg, seed=3, device="cpu")
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(_flatten(p), _flatten(again)))


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch,item", [
    ("xlstm_350m", "item 8"), ("jamba_1_5_large_398b", "item 8"),
    ("mixtral_8x7b", "item 7"), ("whisper_large_v3", "item 9"),
])
def test_unported_blocks_raise_with_roadmap_item(arch, item):
    with pytest.raises(NotImplementedError, match=item):
        M.init_model(reduced(get_config(arch)), device="cpu")


def test_params_from_jax_checks_layout():
    c = case("smollm_360m")
    tree = jax.tree.map(np.asarray, c["jparams"])
    wrong = dataclasses.replace(c["tcfg"], n_layers=4)
    with pytest.raises(ValueError, match="n_repeats"):
        params_from_jax(tree, wrong, device="cpu")
    bf16 = params_from_jax(jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
                                        tree), c["tcfg"], device="cpu")
    assert bf16["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        bf16["embed"].float().numpy(),
        np.asarray(jnp.asarray(tree["embed"], jnp.bfloat16).astype(jnp.float32)))
