"""Whisper-large-v3's encoder-decoder in the port against the JAX package.

Reduced whisper (``reduced``: d_model 64, 4 heads, hd 16, 2 encoder and 2
decoder layers, f32) in two cases: the reduced config's 8 encoder frames,
and 12. The decoder runs S = 10 tokens, so cross-attention's queries and
keys differ in length both ways and Sq != Skv cannot pass by accident.
Parameters come from JAX ``init_model`` through ``params_from_jax``;
tokens and frame embeddings from numpy seeds. Tolerances as
``tests/test_torch_models.py``: encode and forward 1e-4 relative, each
decode step and cache 1e-4, decode against forward 1e-3.

The reference's decode never fills its cross-attention cache:
``init_cache`` makes ``cross_k`` / ``cross_v`` zeros and no function writes
them, so its decode attends over zeros and differs from its own
``forward`` (``test_jax_unfilled_decode_differs_from_its_forward``). The
port fills the cache from the encoder (``prefill_cross``); its decode is
held to JAX's ``decode_step`` with JAX's cache filled by hand from JAX's
own ``encode(...) @ wk`` and ``@ wv``.

On the CPU the port's attention runs the plain versions of its kernels;
the cross-attention cases hold them to the JAX package's plain oracle
``layers.sdpa`` at Sq != Skv (the Pallas flash kernel reads its length
from q, so it is no oracle there).
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
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops
from repro_torch.kernels.ref import flash_attention_lse_ref
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.models import model as M

from _jax_whisper import jax_cache_filled_by_hand
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARCH = "whisper_large_v3"
CASES = {"frames8": 8, "frames12": 12}   # encoder frames; the decoder's S is 10
B, S = 2, 10
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def configs(frames):
    jcfg = dataclasses.replace(jax_reduced(jax_get_config(ARCH)), enc_frames=frames)
    tcfg = dataclasses.replace(reduced(get_config(ARCH)), enc_frames=frames)
    return jcfg, tcfg


@functools.cache
def case(name):
    """JAX params and jitted functions, the port's converted params, tokens
    and frames; built once per case and shared by this module's tests."""
    jcfg, tcfg = configs(CASES[name])
    jparams, _ = JM.init_model(jax.random.PRNGKey(1), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    rng = np.random.default_rng(8)
    tokens = rng.integers(0, jcfg.vocab, (B, S), dtype=np.int32)
    embeds = rng.standard_normal((B, jcfg.enc_frames, jcfg.d_model), dtype=np.float32)
    fwd = jax.jit(JM.forward, static_argnums=1)
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tree=tree, tokens=tokens, embeds=embeds,
                tparams=params_from_jax(tree, tcfg, device="cpu"),
                jfull=np.asarray(fwd(jparams, jcfg, jnp.asarray(tokens), jnp.asarray(embeds))),
                dec=jax.jit(JM.decode_step, static_argnums=1))


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def port_decode_all(c):
    cache = M.init_cache(c["tcfg"], B, S, device="cpu")
    M.prefill_cross(c["tparams"], c["tcfg"], cache, torch.from_numpy(c["embeds"]))
    outs = []
    for t in range(S):
        lg, cache = M.decode_step(c["tparams"], c["tcfg"], cache,
                                  torch.from_numpy(c["tokens"][:, t]), t)
        outs.append(lg.numpy())
    return np.stack(outs, axis=1), cache


@pytest.mark.parametrize("name", CASES)
def test_encode_matches_jax(name):
    c = case(name)
    want = np.asarray(JM.encode(c["jparams"], c["jcfg"], jnp.asarray(c["embeds"])))
    got = M.encode(c["tparams"], c["tcfg"], torch.from_numpy(c["embeds"]))
    assert got.shape == (B, CASES[name], c["tcfg"].d_model)
    assert rel_err(got.numpy(), want) <= 1e-4


@pytest.mark.parametrize("name", CASES)
def test_forward_matches_jax(name):
    c = case(name)
    out = M.forward(c["tparams"], c["tcfg"], torch.from_numpy(c["tokens"]),
                    torch.from_numpy(c["embeds"]))
    assert out.shape == (B, S, c["tcfg"].vocab) and out.dtype == torch.float32
    assert rel_err(out.numpy(), c["jfull"]) <= 1e-4


@pytest.mark.parametrize("name", CASES)
def test_decode_matches_forward(name):
    c = case(name)
    dec, _ = port_decode_all(c)
    full = M.forward(c["tparams"], c["tcfg"], torch.from_numpy(c["tokens"]),
                     torch.from_numpy(c["embeds"])).numpy()
    assert rel_err(dec, full) < 1e-3


@pytest.mark.parametrize("name", CASES)
def test_decode_step_matches_jax_with_its_cross_cache_filled_by_hand(name):
    c = case(name)
    jcache = jax_cache_filled_by_hand(c["jcfg"], c["jparams"], c["embeds"], B, S)
    tcache = M.init_cache(c["tcfg"], B, S, device="cpu")
    M.prefill_cross(c["tparams"], c["tcfg"], tcache, torch.from_numpy(c["embeds"]))
    for t in range(S):
        jl, jcache = c["dec"](c["jparams"], c["jcfg"], jcache,
                              jnp.asarray(c["tokens"][:, t]), jnp.int32(t))
        tl, tcache = M.decode_step(c["tparams"], c["tcfg"], tcache,
                                   torch.from_numpy(c["tokens"][:, t]), t)
        assert rel_err(tl.numpy(), jl) <= 1e-4, t
        for jc, tc in zip(jcache, tcache, strict=True):
            assert tc.keys() == jc.keys() == {"k", "v", "cross_k", "cross_v"}
            for key in jc:
                assert rel_err(tc[key].numpy(), jc[key]) <= 1e-4, (t, key)


@pytest.mark.parametrize("name", CASES)
def test_prefill_cross_writes_every_layer_from_the_encoder(name):
    c = case(name)
    tcache = M.init_cache(c["tcfg"], B, S, device="cpu")
    R, F = c["tcfg"].n_repeats, CASES[name]
    assert tcache[0]["cross_k"].shape == (R, B, F, c["tcfg"].n_kv_heads, c["tcfg"].hd)
    assert not tcache[0]["cross_k"].any()
    same = M.prefill_cross(c["tparams"], c["tcfg"], tcache, torch.from_numpy(c["embeds"]))
    assert same is tcache
    jcache = jax_cache_filled_by_hand(c["jcfg"], c["jparams"], c["embeds"], B, S)
    for key in ("cross_k", "cross_v"):
        assert rel_err(tcache[0][key].numpy(), jcache[0][key]) <= 1e-4, key
        assert all(tcache[0][key][r].abs().max() > 0 for r in range(R)), key
    assert not tcache[0]["k"].any()   # the self-attention cache is the decode's to write


def test_jax_unfilled_decode_differs_from_its_forward():
    """The reference's own decode, its cross cache as ``init_cache`` made it,
    attends over zeros: its logits differ from its forward at order 1 and
    the cache stays all zero. With the cache filled by hand they agree."""
    c = case("frames8")
    for filled in (False, True):
        jcache = (jax_cache_filled_by_hand(c["jcfg"], c["jparams"], c["embeds"], B, S) if filled
                  else JM.init_cache(c["jcfg"], B, S))
        steps = []
        for t in range(S):
            lg, jcache = c["dec"](c["jparams"], c["jcfg"], jcache,
                                  jnp.asarray(c["tokens"][:, t]), jnp.int32(t))
            steps.append(np.asarray(lg))
        err = rel_err(np.stack(steps, axis=1), c["jfull"])
        if filled:
            assert err < 1e-3, err
        else:
            assert err > 0.1, err
            assert not any(np.asarray(jc[k]).any() for jc in jcache
                           for k in ("cross_k", "cross_v"))


def test_forward_without_frames_raises():
    c = case("frames8")
    with pytest.raises(ValueError, match="enc_embeds"):
        M.forward(c["tparams"], c["tcfg"], torch.from_numpy(c["tokens"]))


def test_params_from_jax_checks_the_encoder_decoder_layout():
    c = case("frames8")
    p = params_from_jax(c["tree"], c["tcfg"], device="cpu")
    assert set(p) == {"embed", "blocks", "enc_blocks", "enc_norm", "dec_pos", "final_norm",
                      "lm_head"}
    assert {"cross", "cross_norm"} <= set(p["blocks"][0])
    assert "bq" not in p["blocks"][0]["cross"]
    wrong = dataclasses.replace(c["tcfg"], n_enc_layers=3)
    with pytest.raises(ValueError, match="n_enc_layers"):
        params_from_jax(c["tree"], wrong, device="cpu")
    no_pos = {k: v for k, v in c["tree"].items() if k != "dec_pos"}
    with pytest.raises(ValueError, match="dec_pos"):
        params_from_jax(no_pos, c["tcfg"], device="cpu")
    short = {**c["tree"], "dec_pos": c["tree"]["dec_pos"][:64]}
    with pytest.raises(ValueError, match="dec_pos"):
        params_from_jax(short, c["tcfg"], device="cpu")
    # decoder blocks with cross-attention under a decoder-only config
    decoder_only = dataclasses.replace(c["tcfg"], enc_dec=False)
    with pytest.raises(ValueError, match="cross"):
        params_from_jax(c["tree"], decoder_only, device="cpu")


def test_init_model_layout_and_scales_match_jax():
    _, tcfg = configs(8)
    p = M.init_model(tcfg, seed=3, device="cpu")
    jp, _ = JM.init_model(jax.random.PRNGKey(0), jax_reduced(jax_get_config(ARCH)))
    flat_t = dict(_flatten(p))
    flat_j = {k: np.asarray(v) for k, v in _flatten(jax.tree.map(np.asarray, jp))}
    assert flat_t.keys() == flat_j.keys()
    for k, v in flat_t.items():
        assert tuple(v.shape) == flat_j[k].shape, k
        sj, st = float(np.std(flat_j[k])), float(v.float().std())
        assert abs(st - sj) <= 0.1 * sj + 1e-6, (k, st, sj)


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def test_request_frames_are_seeded_per_request():
    a = serve.request_frames(3, 1, 2, 12, 64)
    assert a.shape == (2, 12, 64) and a.dtype == np.float32
    np.testing.assert_array_equal(a, serve.request_frames(3, 1, 2, 12, 64))
    assert not np.array_equal(a, serve.request_frames(3, 2, 2, 12, 64))
    # another stream than the prompt's, which is seeded from (seed, rid)
    prompt_stream = np.random.default_rng([3, 1]).standard_normal((2, 12, 64), dtype=np.float32)
    assert not np.array_equal(a, prompt_stream)


# ---------------------------------------------------------------------------
# The kernels' plain versions at Sq != Skv, against the JAX package's oracle
# ---------------------------------------------------------------------------

def make(rng, shape, dtype):
    """The same values for both frameworks: numpy f32, rounded alike to bf16."""
    a = rng.standard_normal(shape, dtype=np.float32)
    return jnp.asarray(a).astype(dtype), torch.from_numpy(a).to(TORCH_DT[dtype])


CROSS_SHAPES = [             # (B, Sq, Skv, H, K, hd)
    (2, 1, 150, 4, 4, 64),   # one decoder token against the frames
    (2, 37, 150, 4, 4, 64),  # ragged, under one 64-row tile
    (1, 100, 8, 4, 2, 16),   # Sq > Skv, GQA
    (2, 10, 12, 4, 4, 16),   # reduced whisper's frames12 case
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Skv,H,K,hd", CROSS_SHAPES)
def test_flash_at_sq_ne_skv_matches_jax_sdpa(dtype, B, Sq, Skv, H, K, hd):
    rng = np.random.default_rng(Sq * 1000 + Skv)
    (jq, tq), (jk, tk), (jv, tv) = (make(rng, (B, n, h, hd), dtype)
                                    for n, h in ((Sq, H), (Skv, K), (Skv, K)))
    got = ops.flash_attention(tq, tk, tv, causal=False)
    want = JL.sdpa(jq, jk, jv, causal=False)
    assert got.shape == (B, Sq, H, hd) and got.dtype == TORCH_DT[dtype]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("Sq,Skv", [(1, 150), (37, 150), (100, 8)])
def test_flash_lse_ref_at_sq_ne_skv_matches_numpy_logsumexp(Sq, Skv):
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, Sq, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, Skv, 2, 16)).astype(np.float32)
    got = flash_attention_lse_ref(torch.from_numpy(q), torch.from_numpy(k), causal=False)
    s = np.einsum("bskgh,btkh->bkgst", q.reshape(2, Sq, 2, 2, 16).astype(np.float64),
                  k.astype(np.float64)) / 4.0
    m = s.max(axis=-1)
    want = (m + np.log(np.exp(s - m[..., None]).sum(axis=-1))).reshape(2, 4, Sq)
    assert got.shape == (2, 4, Sq)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_layer_matches_jax(dtype):
    """``layers.attention`` with ``xkv``: no RoPE, no mask, the keys and
    values projected from the source, against JAX's at Sq 10, Skv 12."""
    jcfg, tcfg = configs(12)
    jcfg, tcfg = (dataclasses.replace(c, dtype=dtype) for c in (jcfg, tcfg))
    p, _ = JL.init_attention(jax.random.PRNGKey(4), jcfg, cross=True)
    tp = {k: torch.from_numpy(np.array(v, np.float32)).to(TORCH_DT[dtype]) for k, v in p.items()}
    rng = np.random.default_rng(6)
    (jx, tx), (je, te) = (make(rng, (B, n, jcfg.d_model), dtype) for n in (S, 12))
    want = JL.attention(p, jx, jcfg, causal=False, xkv=je, use_rope=False)
    got = L.attention(tp, tx, tcfg, causal=False, xkv=te, use_rope=False)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])
    # causal and the window are self-attention's: passing them changes nothing here
    windowed = dataclasses.replace(tcfg, sliding_window=4)
    assert torch.equal(L.attention(tp, tx, windowed, causal=True, xkv=te), got)


def test_cross_decode_matches_jax_sdpa_over_the_whole_cache():
    """``layers.attention_cross_decode``: one token against every frame of
    the filled cross cache, as the reference's decode reads its cache."""
    jcfg, tcfg = configs(12)
    p, _ = JL.init_attention(jax.random.PRNGKey(5), jcfg, cross=True)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    rng = np.random.default_rng(7)
    (jx, tx), = (make(rng, (B, 1, jcfg.d_model), "float32"),)
    (jk, tk), (jv, tv) = (make(rng, (B, 12, jcfg.n_kv_heads, jcfg.hd), "float32")
                          for _ in range(2))
    q = (jx @ p["wq"]).reshape(B, 1, jcfg.n_heads, jcfg.hd)
    want = JL.sdpa(q, jk, jv, causal=False).reshape(B, 1, -1) @ p["wo"]
    got = L.attention_cross_decode(tp, tx, tk, tv, tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


def test_cpu_flash_at_sq_ne_skv_differentiates_as_its_plain_version():
    """On the CPU the wrapper is autograd of the plain version, Sq != Skv
    included; its gradients equal ``jax.grad`` of the JAX oracle."""
    rng = np.random.default_rng(9)
    q, k, v, g = (rng.standard_normal(shape, dtype=np.float32)
                  for shape in ((2, 5, 4, 16), (2, 12, 2, 16), (2, 12, 2, 16), (2, 5, 4, 16)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, causal=False)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    want = jax.grad(lambda a, b, c: jnp.sum(JL.sdpa(a, b, c, causal=False) * g),
                    argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for a, b in zip(got, want, strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)
