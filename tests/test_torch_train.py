"""The port's training path against the JAX reference on the CPU (f32).

Parameters, AdamW states and batches are made by JAX or numpy and passed
through numpy to both frameworks (torch cannot reproduce threefry).
Tolerances:

- ``loss_fn``: abs 1e-5;
- one step's gradients (JAX: ``jax.grad`` of ``repro.models.model.loss_fn``
  with ``use_pallas=False``): per leaf, max abs error <= 1e-4 x max(1, max|g|);
- ``grad_norm``: rel 1e-4;
- ``adamw_update`` on the same numpy grads and state: 1e-6;
- ``cosine_schedule``: 1e-7;
- params after one full step: atol 2e-3 (Adam's first step is about
  lr·sign(g), so an entry whose gradient is near 0 may move the other way in
  the other framework; the gradients are held tightly, the params loosely,
  as in tests/test_models.py);
- microbatched against full batch: loss 1e-3, params 2e-3;
- ``remat`` on and off: loss and gradients equal to the bit on the CPU (the
  recomputed forward repeats the same operations); under ``remat`` held to
  the JAX package under ``remat`` with the tolerances above;
- ``ops.flash_attention``'s autograd Function, and the backward's fp32
  formulas (``ref.flash_attention_bwd_fp32_ref``), against ``jax.grad`` of
  ``repro.models.layers.sdpa``: 1e-5.

Also: the step as a task of the copied engine (injected failures,
identical pricing to the JAX workflow), its purity under re-execution,
checkpoints written by the JAX package and by the port, and the launcher.
xLSTM (reduced xlstm-350m: mLSTM hd 32, sLSTM) is held at S = 64, where
the JAX package's chunk is the whole sequence and its masked ``exp``
cannot overflow (``tests/test_torch_ssm.py``). Reduced whisper-large-v3
(2 + 2 layers, 8 frames) trains on the frames JAX's ``synthetic_batch``
draws, converted through numpy: its encoder, cross-attention at Sq 16
over Skv 8, and the encoder's ``remat``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.models import layers as JL
from repro.models import model as JM
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.optim import cosine_schedule as jcosine_schedule
from repro.runtime import checkpoint as jckpt
from repro.runtime import orchestrator as jorch
from repro.runtime.train import build_train_step as jbuild_train_step
from repro.runtime.train import synthetic_batch as jsynthetic_batch
from repro_torch.configs import get_config, reduced
from repro_torch.convert import opt_state_from_jax, params_from_jax
from repro_torch.kernels import ops
from repro_torch.kernels.ref import flash_attention_bwd_fp32_ref, flash_attention_lse_ref
from repro_torch.launch import train as tlaunch
from repro_torch.models import model as M
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, cosine_schedule
from repro_torch.runtime import checkpoint as ckpt
from repro_torch.runtime import orchestrator as torch_orch
from repro_torch.runtime.train import build_train_step, synthetic_batch
from repro_torch.tree import leaves, map_tree, paths

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARCHS = ["smollm_360m", "qwen2_72b", "nemotron_4_340b_hd192", "llama3_405b", "chameleon_34b",
         "xlstm_350m", "mixtral_8x7b", "mixtral_8x22b", "jamba_1_5_large_398b_8layers",
         "whisper_large_v3"]
B, S = 4, 16
SEQ = {"xlstm_350m": 64}     # S by arch, where not S
OPT = dict(lr=1e-3, warmup=3)
MAMBA_LEAVES = ("in_proj", "x_proj", "dt_proj", "out_proj", "A_log", "D", "dt_bias")
# the encoder-decoder's own leaves, each of which must get a gradient
WHISPER_LEAVES = (("enc_blocks", "mixer", "wq"), ("enc_blocks", "mlp", "w_up"),
                  ("enc_blocks", "norm1", "scale"), ("enc_norm", "scale"), ("dec_pos",),
                  ("blocks", 0, "cross_norm", "scale"),
                  *(("blocks", 0, "cross", name) for name in ("wq", "wk", "wv", "wo")))


def configs(arch, **kw):
    """(JAX config, port config) of the reduced ``arch``, ``kw`` replaced;
    ``<arch>_hd192`` keeps the head dim at 192 (nemotron-4-340b's),
    ``<arch>_8layers`` one period of jamba's pattern (JAX marks 16 slow)."""
    if arch.endswith("_hd192"):
        arch, kw = arch.removesuffix("_hd192"), {"head_dim": 192, **kw}
    if arch.endswith("_8layers"):
        arch, kw = arch.removesuffix("_8layers"), {"n_layers": 8, **kw}
    return (dataclasses.replace(jax_reduced(jax_get_config(arch)), **kw),
            dataclasses.replace(reduced(get_config(arch)), **kw))


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def tensors(tree):
    return map_tree(lambda a: torch.from_numpy(np.array(a)), tree)


@functools.cache
def case(arch, remat=False):
    """JAX params (qkv biases made non-zero), a batch, and JAX's loss,
    gradients and one full train step; built once per arch (and remat)."""
    jcfg, tcfg = configs(arch, remat=remat)
    jparams, _ = JM.init_model(jax.random.PRNGKey(3), jcfg)
    tree = to_numpy(jparams)
    if jcfg.qkv_bias:  # the reference inits biases at zero: make them count
        rng = np.random.default_rng(7)
        for blk in tree["blocks"]:
            for name in ("bq", "bk", "bv"):
                blk["mixer"][name] = rng.standard_normal(
                    blk["mixer"][name].shape, dtype=np.float32) * 0.1
        jparams = jax.tree.map(jnp.asarray, tree)
    batch = to_numpy(jsynthetic_batch(jcfg, B, SEQ.get(arch, S), seed=5))
    jbatch = jax.tree.map(jnp.asarray, batch)
    loss, grads = jax.jit(jax.value_and_grad(JM.loss_fn), static_argnums=1)(
        jparams, jcfg, jbatch["tokens"], jbatch["labels"], jbatch.get("enc_embeds"))
    opt = jadamw_init(jparams)
    p1, o1, m1 = jax.jit(jbuild_train_step(jcfg, JAdamWConfig(**OPT)))(jparams, opt, jbatch)
    return dict(jcfg=jcfg, tcfg=tcfg, tree=tree, jparams=jparams, batch=batch,
                loss=float(loss), grads=to_numpy(grads), step_params=to_numpy(p1),
                step_opt=to_numpy(o1), step_metrics=to_numpy(m1))


def port_params(c):
    return params_from_jax(c["tree"], c["tcfg"], device="cpu")


def port_batch(c):
    return {k: torch.from_numpy(v.copy()) for k, v in c["batch"].items()}


def pairs(got, want):
    """(path, port leaf, reference leaf) over two trees of one structure,
    matched by path (JAX orders dict keys sorted, the port by insertion)."""
    g, w = dict(paths(got)), dict(paths(want))
    assert g.keys() == w.keys()
    return [(k, g[k], w[k]) for k in g]


def max_abs(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_matches_jax(arch):
    c = case(arch)
    b = port_batch(c)
    loss = M.loss_fn(port_params(c), c["tcfg"], b["tokens"], b["labels"], b.get("enc_embeds"))
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert abs(loss.item() - c["loss"]) < 1e-5, (loss.item(), c["loss"])


def port_grads(c, cfg=None):
    p = map_tree(lambda t: t.requires_grad_(), port_params(c))
    b = port_batch(c)
    loss = M.loss_fn(p, cfg or c["tcfg"], b["tokens"], b["labels"], b.get("enc_embeds"))
    loss.backward()
    return loss.detach(), map_tree(lambda t: t.grad, p)


def assert_grads_match(got, want):
    for _, g, w in pairs(got, want):
        assert g is not None and tuple(g.shape) == w.shape
        err = max_abs(g, w)
        assert err <= 1e-4 * max(1.0, float(np.max(np.abs(w)))), err


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_jax_grad(arch):
    c = case(arch)
    _, got = port_grads(c)
    assert_grads_match(got, c["grads"])
    # the first mixer's projections (attention, mLSTM or mamba) get a gradient through its output
    mixer = got["blocks"][0]["mixer"]
    names = MAMBA_LEAVES if "in_proj" in mixer else ("wq", "wk", "wv")
    for name in names:
        assert float(mixer[name].abs().max()) > 0, name
    if c["tcfg"].enc_dec:  # the encoder and the cross-attention learn through the decoder
        for path in WHISPER_LEAVES:
            leaf = got
            for key in path:
                leaf = leaf[key]
            assert float(leaf.abs().max()) > 0, path


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch):
    c = case(arch)
    step = build_train_step(c["tcfg"], AdamWConfig(**OPT))
    p0, b = port_params(c), port_batch(c)
    p1, o1, m = step(p0, adamw_init(p0), b)
    jm = c["step_metrics"]
    assert abs(m["loss"].item() - float(jm["loss"])) < 1e-5
    assert abs(m["grad_norm"].item() / float(jm["grad_norm"]) - 1) < 1e-4
    assert abs(m["lr_scale"].item() - float(jm["lr_scale"])) < 1e-7
    assert int(o1["count"]) == int(c["step_opt"]["count"]) == 1
    for _, got, want in pairs(p1, c["step_params"]):
        assert max_abs(got, want) < 2e-3
    for key in ("mu", "nu"):  # the moments see the same clipped gradients
        for _, got, want in pairs(o1[key], c["step_opt"][key]):
            assert max_abs(got, want) <= 1e-4 * max(1.0, float(np.max(np.abs(want))))


@pytest.mark.parametrize("arch", ["smollm_360m", "xlstm_350m", "whisper_large_v3"])
def test_remat_gives_the_same_loss_and_gradients(arch):
    """``remat`` recomputes each superblock (and whisper's each encoder
    block) in the backward: on the CPU the same loss and gradients to the
    bit; under ``remat`` the port matches the JAX package under ``remat``."""
    c = case(arch)
    loss, grads = port_grads(c)
    remat_cfg = dataclasses.replace(c["tcfg"], remat=True)
    loss_r, grads_r = port_grads(c, remat_cfg)
    assert torch.equal(loss, loss_r)
    for x, y in zip(leaves(grads), leaves(grads_r), strict=True):
        assert torch.equal(x, y)
    jc = case(arch, remat=True)
    assert jc["jcfg"].remat and remat_cfg.remat
    assert abs(loss_r.item() - jc["loss"]) < 1e-5
    assert_grads_match(grads_r, jc["grads"])


def random_opt_inputs(seed=0):
    """Params (one 1-d leaf), gradients and an AdamW state after 4 steps."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (6, 5), "blocks": [{"scale": (5,), "w2": (3, 5, 4)}]}

    def draw(scale):
        def leaf(shape):
            return (rng.standard_normal(shape) * scale).astype(np.float32)
        return {"w": leaf(shapes["w"]),
                "blocks": [{k: leaf(s) for k, s in shapes["blocks"][0].items()}]}

    params, grads = draw(1.0), draw(0.3)
    state = {"mu": draw(0.05), "nu": map_tree(np.abs, draw(0.01)),
             "count": np.asarray(4, np.int32)}
    return params, grads, state


@pytest.mark.parametrize("compress", [None, "bf16"])
def test_adamw_update_matches_jax(compress):
    params, grads, state = random_opt_inputs()
    cfg_kw = dict(lr=1e-2, weight_decay=0.1, clip_norm=0.5, grad_compress=compress)
    jp, js, jm = jadamw_update(*(jax.tree.map(jnp.asarray, t) for t in (grads, state, params)),
                               JAdamWConfig(**cfg_kw), 0.7)
    tstate = {"mu": tensors(state["mu"]), "nu": tensors(state["nu"]),
              "count": torch.tensor(4, dtype=torch.int32)}
    tp, ts, tm = adamw_update(tensors(grads), tstate, tensors(params),
                              AdamWConfig(**cfg_kw), 0.7)
    for _, got, want in pairs((tp, ts), to_numpy((jp, js))):
        assert max_abs(got, want) < 1e-6
    assert abs(tm["grad_norm"].item() - float(jm["grad_norm"])) < 1e-6
    assert ts["count"].dtype == torch.int32 and int(ts["count"]) == 5
    # the 1-d leaf is not decayed: without decay it moves the same
    nodecay, _, _ = adamw_update(tensors(grads), tstate, tensors(params),
                                 AdamWConfig(**{**cfg_kw, "weight_decay": 0.0}), 0.7)
    scale = lambda t: t["blocks"][0]["scale"]  # noqa: E731
    assert torch.equal(scale(tp), scale(nodecay))
    assert not torch.equal(tp["w"], nodecay["w"])


def test_adamw_update_writes_nothing_in_place():
    params, grads, state = random_opt_inputs(1)
    tp, tg = tensors(params), tensors(grads)
    ts = {"mu": tensors(state["mu"]), "nu": tensors(state["nu"]),
          "count": torch.tensor(4, dtype=torch.int32)}
    before = [t.clone() for t in leaves(tp) + leaves(tg) + leaves(ts)]
    adamw_update(tg, ts, tp, AdamWConfig(grad_compress="bf16"))
    for t, b in zip(leaves(tp) + leaves(tg) + leaves(ts), before, strict=True):
        assert torch.equal(t, b)


def test_cosine_schedule_matches_jax():
    warmup, total = 10, 100
    for step in (0, warmup - 1, warmup, 50, total + 7):
        want = float(jcosine_schedule(step, warmup=warmup, total=total))
        got = cosine_schedule(torch.tensor(step, dtype=torch.int32), warmup=warmup, total=total)
        assert got.dtype == torch.float32
        assert abs(got.item() - want) < 1e-7, (step, got.item(), want)
    assert cosine_schedule(0, warmup=warmup).item() == pytest.approx(1 / warmup)


def microbatched_equals_full_batch(arch):
    """Four microbatches against the full batch (whisper's frames split with
    the tokens, as the reference's ``split``): loss 1e-3, params 2e-3."""
    c = case(arch)
    p0, b = port_params(c), port_batch(c)
    p1, _, m1 = build_train_step(c["tcfg"], AdamWConfig())(p0, adamw_init(p0), b)
    p4, _, m4 = build_train_step(c["tcfg"], AdamWConfig(), n_microbatches=4)(
        p0, adamw_init(p0), b)
    assert abs(m1["loss"].item() - m4["loss"].item()) < 1e-3
    assert max(max_abs(a, b) for a, b in zip(leaves(p1), leaves(p4))) < 2e-3


def test_microbatching_matches_full_batch():
    microbatched_equals_full_batch("smollm_360m")


def test_whisper_microbatching_splits_the_frames_with_the_tokens():
    microbatched_equals_full_batch("whisper_large_v3")


def step_twice(arch):
    """Two runs of one step on one state (the engine may re-run a task):
    identical results, the state left as it was."""
    c = case(arch)
    p0, b = port_params(c), port_batch(c)
    o0 = adamw_init(p0)
    o0 = {**o0, "count": torch.tensor(2, dtype=torch.int32)}
    before = [t.clone() for t in leaves((p0, o0))]
    step = build_train_step(c["tcfg"], AdamWConfig(**OPT))
    first, second = step(p0, o0, b), step(p0, o0, b)
    for x, y in zip(leaves(first), leaves(second), strict=True):
        assert torch.equal(x, y)
    for t, orig in zip(leaves((p0, o0)), before, strict=True):
        assert torch.equal(t, orig)
    assert not any(t.requires_grad for t in leaves(first))


def test_step_twice_on_one_state_is_identical_and_leaves_it_unchanged():
    step_twice("smollm_360m")


def test_xlstm_step_twice_is_identical_and_leaves_the_state_unchanged():
    step_twice("xlstm_350m")


def test_whisper_step_twice_is_identical_and_leaves_the_state_unchanged():
    step_twice("whisper_large_v3")


def test_mixtral_step_twice_is_identical_and_leaves_the_state_unchanged():
    """The MoE MLP's gather dispatch and its backward repeat to the bit."""
    step_twice("mixtral_8x7b")


def test_whisper_step_without_frames_raises():
    """A batch without frames fails as the encoder-decoder's forward does."""
    c = case("whisper_large_v3")
    p0, b = port_params(c), port_batch(c)
    del b["enc_embeds"]
    with pytest.raises(ValueError, match="enc_embeds"):
        build_train_step(c["tcfg"], AdamWConfig())(p0, adamw_init(p0), b)


def test_synthetic_batch_is_seeded_and_rolled():
    _, tcfg = configs("smollm_360m")
    a = synthetic_batch(tcfg, 2, 8, seed=3, device="cpu")
    b = synthetic_batch(tcfg, 2, 8, seed=3, device="cpu")
    assert torch.equal(a["tokens"], b["tokens"])
    assert torch.equal(a["labels"], torch.roll(a["tokens"], -1, dims=1))
    assert int(a["tokens"].min()) >= 0 and int(a["tokens"].max()) < tcfg.vocab


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_synthetic_batch_draws_seeded_frames_for_the_encoder_decoder(dtype):
    _, tcfg = configs("whisper_large_v3", dtype=dtype)
    a = synthetic_batch(tcfg, 2, 8, seed=3, device="cpu")
    b = synthetic_batch(tcfg, 2, 8, seed=3, device="cpu")
    other = synthetic_batch(tcfg, 2, 8, seed=4, device="cpu")
    frames = a["enc_embeds"]
    assert frames.shape == (2, tcfg.enc_frames, tcfg.d_model)
    assert frames.dtype == getattr(torch, dtype)
    assert torch.equal(frames, b["enc_embeds"]) and torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(frames, other["enc_embeds"])
    # drawn after the tokens: the tokens are those of the decoder-only batch
    _, smollm = configs("smollm_360m", vocab=tcfg.vocab)
    assert torch.equal(a["tokens"], synthetic_batch(smollm, 2, 8, seed=3, device="cpu")["tokens"])
    assert 0.5 < float(frames.float().std()) < 1.5
    assert "enc_embeds" not in synthetic_batch(smollm, 2, 8, seed=3, device="cpu")


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

def test_train_step_through_engine_with_injected_failures():
    """The pattern of tests/test_runtime.py: seed 8 injects recoverable
    failures (at attempt 0 only) into this 5-step chain."""
    c = case("smollm_360m")
    step = build_train_step(c["tcfg"], AdamWConfig(**OPT))
    p0 = port_params(c)

    def step_fn(state, i):
        p, o = state
        p, o, m = step(p, o, port_batch(c))
        return (p, o), {"loss": float(m["loss"])}

    dag, final_key, mk = torch_orch.build_training_workflow(
        n_steps=5, step_fn=step_fn, init_fn=lambda: (p0, adamw_init(p0)))
    cfg = tcore.EngineConfig(faults=tcore.FaultConfig(task_failure_prob=0.05, max_retries=2,
                                                      seed=8))
    res = torch_orch.run_training_workflow(dag, final_key, mk, cfg)
    assert res.report.fault_stats["injected_failures"] > 0
    _, final_opt = res.report.results[final_key]
    assert int(final_opt["count"]) == 5
    losses = [res.report.results[k]["loss"] for k in mk]
    assert all(np.isfinite(losses))


def test_training_dag_prices_identically_through_both_engines():
    """Same DAG, one driven by the JAX step through ``repro.runtime``, one
    by the port's step through its copy: identical price and faults."""
    c = case("smollm_360m")
    batch = c["batch"]

    def run(orch, core, step, init, to_batch):
        def step_fn(state, b):
            p, o = state
            p, o, m = step(p, o, to_batch(b))
            return (p, o), {"loss": float(m["loss"])}

        dag, final_key, mk = orch.build_training_workflow(
            n_steps=3, step_fn=step_fn, init_fn=init, data_fn=lambda i: batch,
            checkpoint_fn=lambda st, i: i, checkpoint_every=2)
        cfg = core.EngineConfig(faults=core.FaultConfig(task_failure_prob=0.2, max_retries=6,
                                                        seed=3))
        return orch.run_training_workflow(dag, final_key, mk, cfg)

    jstep = jax.jit(jbuild_train_step(c["jcfg"], JAdamWConfig(**OPT)))
    j = run(jorch, jcore, jstep, lambda: (c["jparams"], jadamw_init(c["jparams"])),
            lambda b: jax.tree.map(jnp.asarray, b))
    p0 = port_params(c)
    t = run(torch_orch, tcore, build_train_step(c["tcfg"], AdamWConfig(**OPT)),
            lambda: (p0, adamw_init(p0)), lambda b: tensors(b))
    assert j.report.fault_stats["injected_failures"] > 0
    assert j.report.charged_ms == t.report.charged_ms
    assert j.report.kv_stats == t.report.kv_stats
    assert j.report.fault_stats == t.report.fault_stats
    for k in j.metric_keys:
        assert abs(j.report.results[k]["loss"] - t.report.results[k]["loss"]) < 1e-4


# ---------------------------------------------------------------------------
# Checkpoints and the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_checkpoint_restores_into_the_port(tmp_path, dtype):
    jcfg, tcfg = configs("smollm_360m", dtype=dtype)
    jparams, _ = JM.init_model(jax.random.PRNGKey(4), jcfg)
    jopt = jadamw_init(jparams)
    path = str(tmp_path / "jax.npz")
    jckpt.save(path, {"params": jparams, "opt": jopt}, step=7)
    like = {"params": M.init_model(tcfg, seed=1, device="cpu"),
            "opt": adamw_init(M.init_model(tcfg, seed=1, device="cpu"))}
    restored, step = ckpt.restore(path, like)
    assert step == 7 == ckpt.latest_step(path)
    converted = params_from_jax(to_numpy(jparams), tcfg, device="cpu")
    for _, got, want in pairs(restored["params"], converted):
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert restored["opt"]["count"].dtype == torch.int32
    tokens = np.random.default_rng(2).integers(0, tcfg.vocab, (2, 12), dtype=np.int32)
    logits = M.forward(restored["params"], tcfg, torch.from_numpy(tokens))
    assert torch.equal(logits, M.forward(converted, tcfg, torch.from_numpy(tokens)))
    jlogits = np.asarray(JM.forward(jparams, jcfg, jnp.asarray(tokens)))
    tol = 1e-4 if dtype == "float32" else 5e-2
    assert max_abs(logits, jlogits) / float(np.max(np.abs(jlogits))) < tol


def test_jax_xlstm_checkpoint_restores_into_the_port(tmp_path):
    """xLSTM's params (mLSTM and sLSTM stacks) and AdamW state after one JAX
    step, written by the JAX package: restored into the port leaf for leaf,
    written again by the port and restored to the bit, and the restored
    model's logits those of the JAX model (rel 1e-4)."""
    c = case("xlstm_350m")
    jparams = jax.tree.map(jnp.asarray, c["step_params"])
    path = str(tmp_path / "jax.npz")
    jckpt.save(path, {"params": jparams, "opt": jax.tree.map(jnp.asarray, c["step_opt"])},
               step=1)
    p0 = port_params(c)
    restored, step = ckpt.restore(path, {"params": p0, "opt": adamw_init(p0)})
    assert step == 1
    for _, got, want in pairs(restored["params"], c["step_params"]):
        assert torch.equal(got, torch.from_numpy(np.array(want)))
    for key in ("mu", "nu"):
        for _, got, want in pairs(restored["opt"][key], c["step_opt"][key]):
            assert torch.equal(got, torch.from_numpy(np.array(want)))
    assert int(restored["opt"]["count"]) == 1
    again = str(tmp_path / "port.npz")
    ckpt.save(again, restored, step=2, async_=True).join()
    back, step = ckpt.restore(again, {"params": p0, "opt": adamw_init(p0)})
    assert step == 2
    for a, b in zip(leaves(back), leaves(restored), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
    tokens = np.random.default_rng(3).integers(0, c["tcfg"].vocab, (2, 12), dtype=np.int32)
    logits = M.forward(back["params"], c["tcfg"], torch.from_numpy(tokens))
    jlogits = np.asarray(JM.forward(jparams, c["jcfg"], jnp.asarray(tokens)))
    assert max_abs(logits, jlogits) / float(np.max(np.abs(jlogits))) < 1e-4


def test_port_checkpoint_round_trip_is_bit_exact(tmp_path):
    _, tcfg = configs("smollm_360m", dtype="bfloat16")
    p = M.init_model(tcfg, seed=2, device="cpu")
    o = adamw_init(p)
    o = {**o, "count": torch.tensor(3, dtype=torch.int32),
         "mu": map_tree(lambda t: torch.randn(t.shape), o["mu"])}
    path = str(tmp_path / "port.npz")
    ckpt.save(path, {"params": p, "opt": o}, step=3, async_=True).join()
    like = {"params": M.init_model(tcfg, seed=9, device="cpu"), "opt": adamw_init(p)}
    got, step = ckpt.restore(path, like)
    assert step == 3
    for a, b in zip(leaves(got), leaves({"params": p, "opt": o}), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with np.load(path) as z:  # the JAX package's key format
        assert "['params']/['blocks']/[0]/['mixer']/['wq']" in z.files
        assert "['opt']/['count']" in z.files


def test_opt_state_from_jax():
    c = case("smollm_360m")
    st = opt_state_from_jax(c["step_opt"], device="cpu")
    assert st["count"].dtype == torch.int32 and st["count"].dim() == 0
    assert int(st["count"]) == 1
    for _, got, want in pairs(st["mu"], c["step_opt"]["mu"]):
        assert torch.equal(got, torch.from_numpy(np.array(want)))


def test_train_launcher_runs_and_resumes_on_cpu(tmp_path):
    argv = ["--device", "cpu", "--steps", "4", "--batch", "2", "--seq", "16",
            "--ckpt-every", "2", "--ckpt-dir", str(tmp_path), "--fail-prob", "0.05"]
    out = tlaunch.main(argv)
    assert ckpt.latest_step(out["checkpoint"]) == 3
    _, opt = out["final_state"]
    assert int(opt["count"]) == 4
    assert all(np.isfinite(loss) for _, loss in out["losses"])
    again = tlaunch.main(argv[:3] + ["2"] + argv[4:])  # resumes at count 4
    _, opt = again["final_state"]
    assert int(opt["count"]) == 6


# ---------------------------------------------------------------------------
# The attention Function
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("H,K", [(4, 4), (6, 2)])          # G = 1, G = 3
@pytest.mark.parametrize("S,window", [(70, None), (70, 24), (100, None)])  # ragged S
def test_flash_attention_function_matches_jax_grad(H, K, S, window):
    rng = np.random.default_rng(S + H)
    hd = 16
    q = rng.standard_normal((2, S, H, hd), dtype=np.float32)
    k, v = (rng.standard_normal((2, S, K, hd), dtype=np.float32) for _ in range(2))
    dout = rng.standard_normal((2, S, H, hd), dtype=np.float32)
    out, vjp = jax.vjp(lambda a, b, c_: JL.sdpa(a, b, c_, causal=True, window=window),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(dout))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    n = ops.flash_attention.launches
    got = ops.flash_attention(tq, tk, tv, causal=True, window=window)
    assert got.grad_fn is not None
    got.backward(torch.from_numpy(dout))
    assert ops.flash_attention.launches == n  # the CPU runs the plain version
    assert max_abs(got.detach(), out) < 1e-5
    for g, w in zip((tq.grad, tk.grad, tv.grad), want, strict=True):
        assert max_abs(g, w) < 1e-5
    with torch.no_grad():  # no grad wanted: no graph recorded
        assert ops.flash_attention(tq, tk, tv, causal=True, window=window).grad_fn is None


@pytest.mark.parametrize("H,K", [(4, 4), (6, 2)])          # G = 1, G = 3
@pytest.mark.parametrize("S,window", [(70, None), (70, 24), (100, None)])  # ragged S
def test_flash_attention_bwd_fp32_ref_matches_jax_grad(H, K, S, window):
    rng = np.random.default_rng(S + H + 1)
    hd = 16
    q = rng.standard_normal((2, S, H, hd), dtype=np.float32)
    k, v = (rng.standard_normal((2, S, K, hd), dtype=np.float32) for _ in range(2))
    dout = rng.standard_normal((2, S, H, hd), dtype=np.float32)
    out, vjp = jax.vjp(lambda a, b, c_: JL.sdpa(a, b, c_, causal=True, window=window),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = flash_attention_bwd_fp32_ref(
        *(torch.from_numpy(a) for a in (q, k, v, np.asarray(out), dout)),
        causal=True, window=window)
    for g, w in zip(got, vjp(jnp.asarray(dout)), strict=True):
        assert g.dtype == torch.float32
        assert max_abs(g, w) < 1e-5


@pytest.mark.parametrize("route", ["fp32_ref", "function"])
@pytest.mark.parametrize("Sq,Skv", [(16, 70), (70, 16), (37, 100)])  # ragged Skv, both ways
def test_flash_backward_at_sq_ne_skv_matches_jax_grad(route, Sq, Skv):
    """Cross-attention's backward (non-causal, Sq != Skv): the fp32 formulas
    (given the rows' log-sum-exp) and the CPU autograd Function against
    ``jax.grad`` of the JAX package's ``sdpa``."""
    rng = np.random.default_rng(Sq * Skv)
    H, K, hd = 6, 2, 16
    q = rng.standard_normal((2, Sq, H, hd), dtype=np.float32)
    k, v = (rng.standard_normal((2, Skv, K, hd), dtype=np.float32) for _ in range(2))
    dout = rng.standard_normal((2, Sq, H, hd), dtype=np.float32)
    out, vjp = jax.vjp(lambda a, b, c_: JL.sdpa(a, b, c_, causal=False),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    if route == "fp32_ref":
        lse = flash_attention_lse_ref(tq, tk, causal=False)
        got = flash_attention_bwd_fp32_ref(tq, tk, tv, torch.from_numpy(np.array(out)),
                                           torch.from_numpy(dout), causal=False, lse=lse)
    else:
        tq, tk, tv = (t.requires_grad_() for t in (tq, tk, tv))
        y = ops.flash_attention(tq, tk, tv, causal=False)
        assert max_abs(y.detach(), out) < 1e-5
        got = torch.autograd.grad(y, (tq, tk, tv), torch.from_numpy(dout))
    for g, w in zip(got, vjp(jnp.asarray(dout)), strict=True):
        assert tuple(g.shape) == w.shape
        assert max_abs(g, w) < 1e-5
