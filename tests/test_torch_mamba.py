"""Mamba (jamba-1.5-large's mixer) in the port against the JAX reference.

Inputs are made with numpy from a seed, or are JAX-made params converted
through numpy; both frameworks see the same values. Tolerances:

- the scan (``_mamba_scan_chunked``): f32 relative max error 1e-5 (the
  port composes the same products in another tree, Hillis–Steele against
  ``jax.lax.associative_scan``);
- the mixer (``mamba``) on reduced jamba with the published state width
  N = 16: output and both returned states, f32 rel 1e-4 (the mixers' limit
  in tests/test_torch_ssm.py); stepped one token at a time against its own
  forward, rel 1e-3;
- ``params_from_jax`` of reduced jamba's stacks, and the model's and
  cache's layout, leaf by leaf.

The model itself (reduced jamba cut to one period of 8 layers: forward,
decode, decode against forward, loss, gradients and a train step) is a
case of the harnesses in tests/test_torch_models.py and
tests/test_torch_train.py.
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
from repro.models import ssm as jssm
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.models import model as M
from repro_torch.models import ssm
from repro_torch.tree import map_tree, paths

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARCH = "jamba_1_5_large_398b"
B, S = 2, 16


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def torch_of(tree):
    return map_tree(lambda a: torch.from_numpy(np.array(a)), tree)


# ---------------------------------------------------------------------------
# The scan
# ---------------------------------------------------------------------------

def scan_inputs(seed, S, di=8, N=4):
    """deltaA in (0.82, 1] as exp(delta·A) gives it, deltaBu and h0 non-zero."""
    rng = np.random.default_rng(seed)
    dA = np.exp(-rng.uniform(0.0, 0.2, (B, S, di, N))).astype(np.float32)
    dBu = (rng.standard_normal((B, S, di, N)) * 0.1).astype(np.float32)
    h0 = rng.standard_normal((B, di, N)).astype(np.float32)
    return dA, dBu, h0


@pytest.mark.parametrize("S", [64, 256, 512])     # 1, 1 and 2 chunks of min(256, S)
def test_scan_matches_jax(S):
    dA, dBu, h0 = scan_inputs(S, S)
    jhs, jh = jssm._mamba_scan_chunked(jnp.asarray(dA), jnp.asarray(dBu), jnp.asarray(h0))
    ths, th = ssm._mamba_scan_chunked(*map(torch.from_numpy, (dA, dBu, h0)))
    assert ths.shape == (B, S, 8, 4) and th.shape == (B, 8, 4)
    assert rel_err(ths, jhs) <= 1e-5 and rel_err(th, jh) <= 1e-5


def test_scan_refuses_a_sequence_the_chunk_does_not_divide():
    dA, dBu, h0 = scan_inputs(0, 300)
    with pytest.raises(ValueError, match="multiple"):
        ssm._mamba_scan_chunked(*map(torch.from_numpy, (dA, dBu, h0)))


# ---------------------------------------------------------------------------
# The mixer, reduced jamba at N = 16 (d 64, d_inner 128)
# ---------------------------------------------------------------------------

@functools.cache
def mixer_case():
    """JAX mamba params with ``conv_b``, ``dt_bias`` and ``D`` drawn from
    a seed (the reference inits them constant: make them count), as numpy."""
    jcfg = dataclasses.replace(jax_reduced(jax_get_config(ARCH)), ssm_state_dim=16)
    tcfg = dataclasses.replace(reduced(get_config(ARCH)), ssm_state_dim=16)
    jp, _ = jssm.init_mamba(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jp)
    rng = np.random.default_rng(4)
    di = jcfg.d_inner
    tree["conv_b"] = (rng.standard_normal(di) * 0.1).astype(np.float32)
    tree["dt_bias"] = rng.uniform(-4.6, -1.0, di).astype(np.float32)
    tree["D"] = rng.uniform(0.5, 1.5, di).astype(np.float32)
    return jcfg, tcfg, tree


def mixer_state(seed, cfg):
    rng = np.random.default_rng(seed)
    conv = rng.standard_normal((B, cfg.ssm_conv_width - 1, cfg.d_inner)).astype(np.float32)
    st = (rng.standard_normal((B, cfg.d_inner, cfg.ssm_state_dim)) * 0.5).astype(np.float32)
    return conv, st


@pytest.mark.parametrize("S,with_state", [(64, False), (64, True), (512, False), (512, True)])
def test_mamba_matches_jax(S, with_state):
    jcfg, tcfg, tree = mixer_case()
    x = np.random.default_rng(S).standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    state = mixer_state(1, jcfg) if with_state else None
    jy, (jconv, jst) = jssm.mamba(jax.tree.map(jnp.asarray, tree), jnp.asarray(x), jcfg,
                                  state=None if state is None else tuple(map(jnp.asarray, state)))
    ty, (tconv, tst) = ssm.mamba(torch_of(tree), torch.from_numpy(x), tcfg,
                                 state=None if state is None else tuple(torch_of(list(state))))
    assert ty.shape == (B, S, jcfg.d_model)
    assert tconv.shape == (B, jcfg.ssm_conv_width - 1, jcfg.d_inner)
    assert tconv.dtype == torch.float32
    assert tst.shape == (B, jcfg.d_inner, 16) and tst.dtype == torch.float32
    assert rel_err(ty, jy) <= 1e-4
    assert rel_err(tconv, jconv) <= 1e-4
    assert rel_err(tst, jst) <= 1e-4


def test_mamba_stepped_one_token_at_a_time_matches_its_forward():
    """The decode path (chunk 1, no doubling) threads the state through 64
    single-token calls and ends where the forward ends."""
    _, tcfg, tree = mixer_case()
    p = torch_of(tree)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((B, 64, tcfg.d_model))
                         .astype(np.float32))
    full, (conv_f, st_f) = ssm.mamba(p, x, tcfg)
    state, ys = None, []
    for t in range(64):
        y, state = ssm.mamba(p, x[:, t:t + 1], tcfg, state=state)
        ys.append(y)
    assert rel_err(torch.cat(ys, dim=1), full) < 1e-3
    assert rel_err(state[0], conv_f) < 1e-3 and rel_err(state[1], st_f) < 1e-3


# ---------------------------------------------------------------------------
# Conversion and layout: reduced jamba
# ---------------------------------------------------------------------------

def configs(n_layers=8):
    jcfg, tcfg = jax_reduced(jax_get_config(ARCH)), reduced(get_config(ARCH))
    return (dataclasses.replace(jcfg, n_layers=n_layers),
            dataclasses.replace(tcfg, n_layers=n_layers))


def test_params_from_jax_takes_jamba_stacks():
    """Reduced jamba (16 layers: 8 pattern positions, each stacked over 2
    repeats) converts leaf by leaf, and a wrong depth is refused."""
    jcfg, tcfg = configs(16)
    jparams, _ = JM.init_model(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    p = params_from_jax(tree, tcfg, device="cpu")
    assert len(p["blocks"]) == 8 and tcfg.n_repeats == 2
    want = dict(paths(tree))
    got = dict(paths(p))
    assert got.keys() == want.keys()
    for k, t in got.items():
        assert tuple(t.shape) == want[k].shape and str(t.dtype).removeprefix("torch.") == \
            str(want[k].dtype), k
        np.testing.assert_array_equal(t.numpy(), want[k])
    mixer = p["blocks"][0]["mixer"]
    assert tuple(mixer["in_proj"].shape) == (2, tcfg.d_model, 2 * tcfg.d_inner)
    assert tuple(mixer["A_log"].shape) == (2, tcfg.d_inner, tcfg.ssm_state_dim)
    with pytest.raises(ValueError, match="n_repeats"):
        params_from_jax(tree, configs(8)[1], device="cpu")


def test_init_model_and_cache_match_the_reference_layout():
    jcfg, tcfg = configs()
    jparams, _ = JM.init_model(jax.random.PRNGKey(1), jcfg)
    p = M.init_model(tcfg, seed=0, device="cpu")
    want = dict(paths(jax.tree.map(np.asarray, jparams)))
    got = dict(paths(p))
    assert got.keys() == want.keys()
    for k, t in got.items():
        assert tuple(t.shape) == want[k].shape, k
    jcache = JM.init_cache(jcfg, B, S)
    tcache = M.init_cache(tcfg, B, S, device="cpu")
    for jc, tc in zip(jcache, tcache, strict=True):
        assert tc.keys() == jc.keys()
        for name in jc:
            assert tuple(tc[name].shape) == jc[name].shape
            assert str(tc[name].dtype).removeprefix("torch.") == str(jc[name].dtype)
