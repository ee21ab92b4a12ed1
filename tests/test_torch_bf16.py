"""bf16 decode against forward, in the JAX reference and in the port (CPU).

Step-by-step decode and one forward compute the same function; in bf16
each rounds in its own places, so their logits differ. How much depends on
the model and grows with depth: at ``reduced`` size (a few layers) the
two models differ alike, but at full depth and a narrow width (d_model
256, vocab 1024, otherwise ``reduced``) the JAX reference's xlstm-350m
differs many times more than its smollm-360m, and by more than smollm's
limit of 5e-2, so the excess is the model's and not the port's. The card
test ``test_decode_matches_forward_at_full_width_on_card``
(``tests/test_torch_cuda.py``) holds the full-width models to the limits
in ``LIMIT``. Parameters come
from JAX ``init_model`` through ``params_from_jax``; ``pytest -s`` prints
the readings.

mixtral's top-2 routing turns a small difference into a large one: where
a token's 2nd and 3rd router logits nearly tie, the two paths can choose
different experts (a flip). Which paths flip depends on where they round
attention's probabilities. The JAX package's plain path runs ``sdpa`` in
both (probabilities rounded to bf16 before p·v) and flips no routing; its
kernel path (``use_pallas``: the Pallas flash kernel keeps them in fp32,
decode still runs ``sdpa``) flips some, and so does the port, whose
forward rounds them and whose decode, like the reference's Pallas decode
kernel, does not. With its decode computed as ``sdpa`` the port flips
none. The card limit holds the positions whose routing agrees to
``LIMIT`` and the share of flips to ``FLIP_SHARE``.

jamba-1.5-large (one attention layer per eight, mamba in the other seven,
MoE on alternate layers) flips routings on the JAX package's plain path
too: at the card's depth (one superblock of 8 layers, with the published
state width N = 16 and the card's 8 experts, at d_model 256 and vocab
1024: ``depth="superblock"``) the reference flips up to 2.3 % over five
seeds and its agreeing positions differ by up to 0.089, so jamba's card
limits are about twice those largest readings (``LIMIT`` and
``FLIP_SHARE``, which the card test keeps). At full depth (72
layers) the reference flips 8.0 % and differs by 0.13 where it agrees;
there the port is held to twice the reference's own reading. The port's
decode attention computed as ``sdpa`` flips almost none on the CPU, so
the reference's excess is not the port's.

whisper-large-v3 (encoder-decoder) keeps smollm's limit: at the card's
depth (32 encoder and 32 decoder layers, d_model 256, vocab 1024, 150
frames: a tenth of the card's 1500, to keep the CPU run short) the JAX
package's plain path reads 0.010 and the port 0.015, and the card 0.018
at full width (``PERF.md`` §6). The reference's decode never fills
its cross cache, so its reading here fills it by hand from its own
``encode(...) @ wk`` / ``@ wv``.
"""
import dataclasses
import functools
from typing import NamedTuple

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
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import model as M

from _jax_whisper import jax_cache_filled_by_hand
from _moe_routes import routes_recorded, routing_flips
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

B, S = 2, 64
# The card's bf16 limits (tests/test_torch_cuda.py keeps the same): over the
# positions whose routing agrees (all positions without MoE), and the share of
# (token, layer) routings that flip
LIMIT = {"smollm_360m": 5e-2, "xlstm_350m": 0.15, "mixtral_8x7b": 5e-2,
         "jamba_1_5_large_398b": 0.18, "whisper_large_v3": 5e-2}
FLIP_SHARE = {"mixtral_8x7b": 0.05, "jamba_1_5_large_398b": 0.05}
JAMBA = "jamba_1_5_large_398b"
SEEDS = range(5)        # jamba's readings at the card's depth


class Reading(NamedTuple):
    err: float            # relative max error of decode against forward
    err_agreeing: float   # the same over the positions whose routing agrees in every layer
    flip_share: float     # share of (token, layer) MoE routings that differ (0 without MoE)


def shape(get, shrink, arch, depth):
    """``arch`` reduced in bf16; at ``depth="full"`` with all its layers,
    d_model 256 and vocab 1024; at ``depth="superblock"`` (jamba) as the
    card cuts it, one superblock of 8 layers with N = 16 and 8 experts, at
    d_model 256 and vocab 1024."""
    cfg = dataclasses.replace(shrink(get(arch)), dtype="bfloat16")
    if depth == "full":
        cfg = dataclasses.replace(cfg, n_layers=get(arch).n_layers, d_model=256, vocab=1024)
    if depth == "full" and cfg.enc_dec:   # the encoder's depth too; a tenth of the frames
        cfg = dataclasses.replace(cfg, n_enc_layers=get(arch).n_enc_layers,
                                  enc_frames=get(arch).enc_frames // 10)
    if depth == "superblock":
        cfg = dataclasses.replace(cfg, n_layers=8, d_model=256, vocab=1024,
                                  ssm_state_dim=get(arch).ssm_state_dim,
                                  moe=dataclasses.replace(cfg.moe, n_experts=8))
    return cfg


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@functools.cache
def setup(arch, depth, seed=0):
    """JAX weights and tokens, the same for every reading of ``arch``."""
    jcfg = shape(jax_get_config, jax_reduced, arch, depth)
    jparams, _ = JM.init_model(jax.random.PRNGKey(1 + seed), jcfg)
    tokens = np.random.default_rng(8 + seed).integers(0, jcfg.vocab, (B, S), dtype=np.int32)
    return jcfg, jparams, tokens


def reading(arch, depth, who, dec, full, experts):
    flips = (routing_flips(experts, S) if experts
             else torch.zeros((1, B, S), dtype=torch.bool))
    flipped = flips.any(dim=0).numpy()
    r = Reading(rel_err(dec, full), rel_err(np.where(flipped[..., None], full, dec), full),
                float(flips.float().mean()))
    print(f"\n{arch} bf16 decode vs forward, {depth} depth, {who}: {r.err:.4g}, over "
          f"agreeing positions {r.err_agreeing:.4g}, routings flipped {r.flip_share:.2%}")
    return r


@functools.cache
def jax_reading(arch, depth, use_pallas=False, seed=0):
    """The JAX package's reading, on its plain path or its kernel path."""
    jcfg, jparams, tokens = setup(arch, depth, seed)
    jcfg = dataclasses.replace(jcfg, use_pallas=use_pallas)
    experts, moe = [], JM.moe_mlp

    def recorded(p, x, cfg):  # each MoE layer's chosen experts, in call order
        g = min(cfg.moe_group, x.shape[1])
        logits = x.reshape(-1, g, x.shape[-1]).astype(jnp.float32) @ p["router"]
        _, chosen = jax.lax.top_k(logits, cfg.moe.top_k)
        jax.debug.callback(lambda c: experts.append(np.array(c).reshape(B, -1, c.shape[-1])),
                           chosen, ordered=True)
        return moe(p, x, cfg)

    JM.moe_mlp = recorded
    try:  # new functions, so that jit traces them with the recorder in place
        full = jax.jit(lambda p, t: JM.forward(p, jcfg, t))(jparams, jnp.asarray(tokens))
        dec = jax.jit(lambda p, c, tok, t: JM.decode_step(p, jcfg, c, tok, t))
        cache, steps = JM.init_cache(jcfg, B, S), []
        for t in range(S):
            lg, cache = dec(jparams, cache, jnp.asarray(tokens[:, t]), t)
            steps.append(np.asarray(lg, np.float32))
        jax.effects_barrier()
    finally:
        JM.moe_mlp = moe
    who = "JAX kernel path" if use_pallas else "JAX"
    return reading(arch, depth, who, np.stack(steps, axis=1), np.asarray(full, np.float32),
                   experts)


def decode_as_sdpa(q, k_cache, v_cache, kv_len):
    """Decode attention with the probabilities rounded as ``sdpa`` rounds
    them; every sequence at the same length, as the model's decode has."""
    return L.sdpa(q[:, None], k_cache, v_cache, causal=False, kv_len=int(kv_len[0]))[:, 0]


@functools.cache
def port_reading(arch, depth, sdpa_decode=False, seed=0):
    """The port's reading; with ``sdpa_decode``, its decode attention
    replaced by ``decode_as_sdpa``."""
    jcfg, jparams, tokens = setup(arch, depth, seed)
    tcfg = shape(get_config, reduced, arch, depth)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    toks = torch.from_numpy(tokens).long()
    decode = ops.decode_attention
    if sdpa_decode:
        ops.decode_attention = decode_as_sdpa
    try:
        with routes_recorded(L) as routes:
            full = M.forward(tparams, tcfg, toks).float().numpy()
            cache, steps = M.init_cache(tcfg, B, S, device="cpu"), []
            for t in range(S):
                lg, cache = M.decode_step(tparams, tcfg, cache, toks[:, t], t)
                steps.append(lg.float().numpy())
    finally:
        ops.decode_attention = decode
    experts = [r.expert.reshape(B, -1, r.expert.shape[-1]) for r in routes]
    who = "port, decode as sdpa" if sdpa_decode else "port"
    return reading(arch, depth, who, np.stack(steps, axis=1), full, experts)


@pytest.mark.parametrize("depth", ["reduced", "full"])
@pytest.mark.parametrize("arch", ["smollm_360m", "xlstm_350m", "mixtral_8x7b",
                                  "jamba_1_5_large_398b"])
def test_bf16_decode_vs_forward_within_the_card_limit(arch, depth):
    jax_r, port_r = jax_reading(arch, depth), port_reading(arch, depth)
    limit, flips = LIMIT[arch], FLIP_SHARE.get(arch, 0.0)
    if (arch, depth) == (JAMBA, "full"):
        # 72 layers, nine times the card's 8: the reference itself exceeds the
        # card's limits there, and the port is held to twice its reading
        limit, flips = 2 * jax_r.err_agreeing, 2 * jax_r.flip_share
    assert jax_r.err_agreeing < limit and port_r.err_agreeing < limit, (jax_r, port_r)
    for r in (jax_r, port_r):
        assert r.flip_share <= flips, r


@pytest.mark.parametrize("seed", SEEDS)
def test_jamba_at_the_cards_depth_within_the_card_limit(seed):
    """jamba as the card cuts it (``depth="superblock"``), over five seeds:
    the reference and the port both within the card's limits."""
    for r in (jax_reading(JAMBA, "superblock", seed=seed),
              port_reading(JAMBA, "superblock", seed=seed)):
        assert r.err_agreeing < LIMIT[JAMBA] and r.flip_share <= FLIP_SHARE[JAMBA], r


def test_jamba_card_limits_are_twice_the_references_reading_at_the_cards_depth():
    """The reference's plain path flips jamba's routings at the card's depth
    too, and the card's limits are about twice its largest readings over
    the five seeds (2.3 % of routings flipped, 0.089 where they agree)."""
    readings = [jax_reading(JAMBA, "superblock", seed=seed) for seed in SEEDS]
    flips = max(r.flip_share for r in readings)
    err = max(r.err_agreeing for r in readings)
    assert flips > 0.0, readings
    assert 1.5 * flips <= FLIP_SHARE[JAMBA] <= 2.5 * flips, (flips, readings)
    assert 1.5 * err <= LIMIT[JAMBA] <= 2.5 * err, (err, readings)


def test_jax_xlstm_amplifies_bf16_rounding():
    """The reference itself: xLSTM's bf16 decode-vs-forward error is many
    times smollm's and above smollm's limit."""
    xlstm = jax_reading("xlstm_350m", "full").err
    smollm = jax_reading("smollm_360m", "full").err
    assert xlstm > 5 * smollm and xlstm > LIMIT["smollm_360m"], (xlstm, smollm)


@pytest.mark.parametrize("depth", ["reduced", "full"])
def test_jax_kernel_path_flips_mixtral_routings_within_the_card_limit(depth):
    """The JAX package's plain path flips no routing; its kernel path, which
    rounds attention's probabilities apart in forward and decode as the port
    does, flips some, within the card's limits."""
    plain = jax_reading("mixtral_8x7b", depth)
    kernels = jax_reading("mixtral_8x7b", depth, use_pallas=True)
    assert plain.flip_share == 0.0, plain
    assert 0.0 < kernels.flip_share <= FLIP_SHARE["mixtral_8x7b"], kernels
    assert kernels.err_agreeing < LIMIT["mixtral_8x7b"], kernels


@pytest.mark.parametrize("depth", ["reduced", "full"])
def test_port_mixtral_flips_come_from_decode_probabilities(depth):
    """With only its decode attention's probabilities rounded as ``sdpa``
    rounds them (as the forward does), the port flips no routing."""
    assert port_reading("mixtral_8x7b", depth).flip_share > 0.0
    as_sdpa = port_reading("mixtral_8x7b", depth, sdpa_decode=True)
    assert as_sdpa.flip_share == 0.0 and as_sdpa.err < LIMIT["mixtral_8x7b"], as_sdpa


def test_jax_jamba_flips_routings_beyond_mixtrals_limits_at_full_depth():
    """The reference itself, on its plain path (``sdpa`` in forward and
    decode, which flips no mixtral routing): at full depth jamba's bf16
    decode and forward choose other experts for more than mixtral's 5 % of
    routings and differ by more than 5e-2 where they agree, and the port's
    decode attention, computed as ``sdpa``, flips far fewer."""
    jax_r = jax_reading("jamba_1_5_large_398b", "full")
    assert jax_r.flip_share > FLIP_SHARE["mixtral_8x7b"], jax_r
    assert jax_r.err_agreeing > LIMIT["mixtral_8x7b"], jax_r
    as_sdpa = port_reading("jamba_1_5_large_398b", "full", sdpa_decode=True)
    assert as_sdpa.flip_share < jax_r.flip_share / 4, as_sdpa


WHISPER = "whisper_large_v3"


@functools.cache
def whisper_reading(depth, who):
    """Whisper's bf16 reading, frames from a numpy seed: the JAX package's
    plain path with its cross cache filled by hand from its own encoder, or
    the port with ``prefill_cross``."""
    jcfg, jparams, tokens = setup(WHISPER, depth)
    frames = np.random.default_rng(9).standard_normal((B, jcfg.enc_frames, jcfg.d_model),
                                                      dtype=np.float32)
    if who == "JAX":
        full = jax.jit(lambda p, t, f: JM.forward(p, jcfg, t, f))(
            jparams, jnp.asarray(tokens), jnp.asarray(frames))
        cache = jax_cache_filled_by_hand(jcfg, jparams, frames, B, S)
        dec = jax.jit(lambda p, c, tok, t: JM.decode_step(p, jcfg, c, tok, t))
        steps = []
        for t in range(S):
            lg, cache = dec(jparams, cache, jnp.asarray(tokens[:, t]), t)
            steps.append(np.asarray(lg, np.float32))
        full = np.asarray(full, np.float32)
    else:
        tcfg = shape(get_config, reduced, WHISPER, depth)
        tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
        toks, tframes = torch.from_numpy(tokens).long(), torch.from_numpy(frames)
        full = M.forward(tparams, tcfg, toks, tframes).float().numpy()
        cache = M.init_cache(tcfg, B, S, device="cpu")
        M.prefill_cross(tparams, tcfg, cache, tframes)
        steps = [M.decode_step(tparams, tcfg, cache, toks[:, t], t)[0].float().numpy()
                 for t in range(S)]
    return reading(WHISPER, depth, who, np.stack(steps, axis=1), full, [])


@pytest.mark.parametrize("depth", ["reduced", "full"])
def test_whisper_bf16_decode_vs_forward_within_the_card_limit(depth):
    """The reference (its cross cache filled by hand) and the port both
    within smollm's limit, which the card test holds whisper to."""
    for who in ("JAX", "port"):
        r = whisper_reading(depth, who)
        assert r.err < LIMIT[WHISPER] and r.flip_share == 0.0, (who, r)
