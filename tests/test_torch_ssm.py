"""The port's mLSTM and sLSTM against the JAX reference (``repro.models.ssm``),
and mamba's init (the mixer itself: tests/test_torch_mamba.py).

Inputs are made with numpy (or are JAX-made params converted through
numpy), and both frameworks see the same values. Tolerances:
``mlstm_chunk`` atol 5e-5, rtol 5e-4 (tests/test_kernels.py); the mixers
f32 relative max error 1e-4 on reduced xlstm-350m. On the CPU
``ops.mlstm_chunk`` runs its plain version; the CUDA kernel runs only on
the card (``tests/test_torch_cuda.py``; the kernel check, ``python3
chip_smoke.py``, at xlstm-350m's width).

The backward: ``mlstm_chunk_bwd_ref`` against ``torch.autograd`` of
``mlstm_chunk_ref`` in float64, max abs error <= 1e-10 x max|autograd|
(the two sum the same terms in another order); ``ops.mlstm_chunk``'s
gradients in f32 against ``jax.grad`` of the JAX oracle at S <= 64, max
abs error <= 1e-4 x max(1, max|g|) (the f32 train tests' rule). JAX's
``wf`` gradient is NaN at S = 256 (its mask applies ``exp`` before the
``where``); the port's must be finite there.
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
from repro.kernels.linear_attention import mlstm_chunk as pallas_mlstm
from repro.kernels.ref import mlstm_chunk_ref as jax_mlstm_ref
from repro.models import ssm as jssm
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops
from repro_torch.kernels.ref import mlstm_chunk_bwd_ref, mlstm_chunk_ref
from repro_torch.models import ssm

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ATOL, RTOL = 5e-5, 5e-4


def gate_inputs(seed, B, S, H, hd):
    """q, k, v, log_f, i_gate as numpy f32, drawn as tests/test_kernels.py
    draws them (q and k scaled by 0.5, sigmoid gates)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, hd), dtype=np.float32) * 0.5
    k = rng.standard_normal((B, S, H, hd), dtype=np.float32) * 0.5
    v = rng.standard_normal((B, S, H, hd), dtype=np.float32)
    z_f = rng.standard_normal((B, S, H), dtype=np.float32)
    z_i = rng.standard_normal((B, S, H), dtype=np.float32)
    log_f = -np.logaddexp(0, -z_f).astype(np.float32)
    i_gate = (1 / (1 + np.exp(-z_i))).astype(np.float32)
    return q, k, v, log_f, i_gate


def torch_of(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def recurrence(q, k, v, log_f, i_gate, C0=None, n0=None):
    """The mLSTM step by step in float64 (the definition the chunkwise form
    computes): C <- f C + i k v^T, n <- f n + i k, y = q.C / max(|q.n|, 1)."""
    B, S, H, hd = q.shape
    C = np.zeros((B, H, hd, hd)) if C0 is None else C0.astype(np.float64)
    n = np.zeros((B, H, hd)) if n0 is None else n0.astype(np.float64)
    ys = []
    for t in range(S):
        f, i = np.exp(log_f[:, t])[..., None], i_gate[:, t][..., None]
        C = f[..., None] * C + (i * k[:, t])[..., None] * v[:, t][:, :, None, :]
        n = f * n + i * k[:, t]
        y = np.einsum("bhk,bhkv->bhv", q[:, t], C)
        nrm = np.einsum("bhk,bhk->bh", q[:, t], n)
        ys.append(y / np.maximum(np.abs(nrm), 1.0)[..., None])
    return np.stack(ys, axis=1), C, n


def close(port, ref, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=atol, rtol=rtol)


MLSTM_SWEEP = [            # tests/test_kernels.py:71-75
    (2, 128, 2, 32, 32),
    (1, 256, 4, 64, 64),
    (2, 256, 1, 16, 128),
]


@pytest.mark.parametrize("B,S,H,hd,chunk", MLSTM_SWEEP)
def test_mlstm_chunk_ref_matches_jax_oracle_and_pallas(B, S, H, hd, chunk):
    arrays = gate_inputs(2, B, S, H, hd)
    y, _ = mlstm_chunk_ref(*torch_of(*arrays), chunk=chunk)
    jin = [jnp.asarray(a) for a in arrays]
    close(y, jax_mlstm_ref(*jin, chunk=64))
    close(y, pallas_mlstm(*jin, chunk=chunk, interpret=True))


@pytest.mark.parametrize("chunk", [16, 64])
def test_mlstm_chunk_ref_final_state_and_initial_state(chunk):
    """Final (C, n) from zero state, and a run split in two halves whose
    second half starts from the first's state, against the float64
    recurrence."""
    B, S, H, hd = 2, 96, 2, 16
    q, k, v, lf, ig = gate_inputs(3, B, S, H, hd)
    want_y, want_C, want_n = recurrence(q, k, v, lf, ig)
    y, (C, n) = mlstm_chunk_ref(*torch_of(q, k, v, lf, ig), chunk=chunk)
    close(y, want_y)
    close(C, want_C)
    close(n, want_n)
    half = S // 2
    first = torch_of(q[:, :half], k[:, :half], v[:, :half], lf[:, :half], ig[:, :half])
    second = torch_of(q[:, half:], k[:, half:], v[:, half:], lf[:, half:], ig[:, half:])
    y1, state = mlstm_chunk_ref(*first, chunk=chunk)
    y2, (C2, n2) = mlstm_chunk_ref(*second, chunk=chunk, state=state)
    close(torch.cat([y1, y2], dim=1), want_y)
    close(C2, want_C)
    close(n2, want_n)


@pytest.mark.parametrize("S,chunk", [(100, 32), (37, 64), (130, 64)])
def test_mlstm_chunk_ragged_s_matches_padded_oracle(S, chunk):
    """A ragged S equals the oracle on the input padded with positions that
    keep the state (log_f = 0, i = 0, q = k = v = 0), then cut; with a
    random initial state, the final state equals the recurrence's."""
    B, H, hd = 2, 2, 32
    q, k, v, lf, ig = gate_inputs(4, B, S, H, hd)
    c = min(chunk, S)
    pad = (-S) % c
    padded = [np.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2)) for a in (q, k, v, lf, ig)]
    want = np.asarray(jax_mlstm_ref(*[jnp.asarray(a) for a in padded], chunk=c))[:, :S]
    y, _ = ops.mlstm_chunk(*torch_of(q, k, v, lf, ig), chunk=chunk)
    close(y, want)
    rng = np.random.default_rng(5)
    C0 = rng.standard_normal((B, H, hd, hd), dtype=np.float32) * 0.1
    n0 = rng.standard_normal((B, H, hd), dtype=np.float32)
    want_y, want_C, want_n = recurrence(q, k, v, lf, ig, C0, n0)
    y, (C, n) = ops.mlstm_chunk(*torch_of(q, k, v, lf, ig), chunk=chunk,
                                state=tuple(torch_of(C0, n0)))
    close(y, want_y)
    close(C, want_C)
    close(n, want_n)


def test_ops_mlstm_chunk_on_cpu_is_the_plain_version_and_counts_nothing():
    args = torch_of(*gate_inputs(6, 1, 40, 2, 32))
    before = ops.mlstm_chunk.launches
    y, (C, n) = ops.mlstm_chunk(*args, chunk=64)       # clamps to S = 40
    ry, (rC, rn) = mlstm_chunk_ref(*args, chunk=40)
    assert torch.equal(y, ry) and torch.equal(C, rC) and torch.equal(n, rn)
    assert ops.mlstm_chunk.launches == before == 0


def normalisers(q, k, log_f, i_gate, n0=None):
    """nrm_t = q_t·n_t of the float64 recurrence (n <- f n + i k)."""
    B, S, H, hd = q.shape
    n = np.zeros((B, H, hd)) if n0 is None else n0.astype(np.float64)
    out = []
    for t in range(S):
        n = np.exp(log_f[:, t])[..., None] * n + i_gate[:, t][..., None] * k[:, t]
        out.append(np.einsum("bhk,bhk->bh", q[:, t], n))
    return np.stack(out, axis=1)


@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("S,chunk", [(64, 64), (70, 32)])      # whole chunks; ragged last chunk
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("final_grads", [False, True])
def test_mlstm_chunk_bwd_ref_matches_autograd(hd, S, chunk, with_state, final_grads):
    B, H = 2, 3
    arrays = [a.astype(np.float64) for a in gate_inputs(12, B, S, H, hd)]
    rng = np.random.default_rng(13)
    state = (rng.standard_normal((B, H, hd, hd)) * 0.1,
             rng.standard_normal((B, H, hd))) if with_state else None
    nrm = np.abs(normalisers(arrays[0], arrays[1], arrays[3], arrays[4],
                             None if state is None else state[1]))
    assert (nrm > 1).any() and (nrm < 1).any()  # both branches of max(|nrm|, 1)
    x = [torch.from_numpy(a).requires_grad_() for a in arrays]
    st = None if state is None else tuple(torch.from_numpy(a).requires_grad_() for a in state)
    y, (C, n) = mlstm_chunk_ref(*x, chunk=chunk, state=st)
    dy = torch.from_numpy(rng.standard_normal(y.shape))
    dC, dn = ((torch.from_numpy(rng.standard_normal(C.shape)),
               torch.from_numpy(rng.standard_normal(n.shape))) if final_grads else (None, None))
    outs, grads_out = [y], [dy]
    if final_grads:
        outs, grads_out = [y, C, n], [dy, dC, dn]
    wrt = x + ([] if st is None else list(st))
    want = torch.autograd.grad(outs, wrt, grads_out)
    got = mlstm_chunk_bwd_ref(*(t.detach() for t in x), y.detach(), dy, chunk=chunk,
                              state=None if st is None else tuple(t.detach() for t in st),
                              dC=dC, dn=dn)
    assert len(got) == 7
    for g, w in zip(got, want):  # dq dk dv dlog_f di [dC0 dn0]
        assert g.dtype == torch.float64 and g.shape == w.shape
        assert (g - w).abs().max().item() <= 1e-10 * w.abs().max().item()
    if not with_state:  # dC0, dn0 are returned all the same
        assert got[5].shape == (B, H, hd, hd) and got[6].shape == (B, H, hd)


@pytest.mark.parametrize("S,chunk", [(64, 64), (64, 16), (48, 48)])
def test_ops_mlstm_chunk_grad_matches_jax_grad(S, chunk):
    """At S <= 64 the JAX oracle's masked exp cannot overflow (see the S =
    256 test), so its gradient is the reference."""
    arrays = gate_inputs(14, 2, S, 3, 32)
    dy = np.random.default_rng(15).standard_normal((2, S, 3, 32), dtype=np.float32)
    _, vjp = jax.vjp(lambda *a: jax_mlstm_ref(*a, chunk=chunk), *map(jnp.asarray, arrays))
    want = vjp(jnp.asarray(dy))
    x = [t.requires_grad_() for t in torch_of(*arrays)]
    before = ops.mlstm_chunk.bwd_launches
    y, _ = ops.mlstm_chunk(*x, chunk=chunk)
    assert y.grad_fn is not None
    y.backward(torch.from_numpy(dy))
    assert ops.mlstm_chunk.bwd_launches == before == 0  # the CPU runs the plain version
    for t, w in zip(x, want, strict=True):
        w = np.asarray(w)
        assert np.abs(t.grad.numpy() - w).max() <= 1e-4 * max(1.0, float(np.abs(w).max()))


def test_mlstm_gradient_at_s256_is_finite_where_jax_wf_gradient_is_nan():
    """The reference behaviour the port must not copy: JAX differentiates
    ``where(mask, exp(rel), 0)``, and above the diagonal of a 256-position
    chunk ``exp(rel)`` overflows, so ``wf``'s gradient is 0 · inf = NaN. The
    port masks ``rel`` with -inf before ``exp``: finite at the reference's
    chunk (256) as at the port's (64)."""
    jcfg, tcfg, jm, _, tm, _ = mixer_case()
    x = np.random.default_rng(16).standard_normal((2, 256, jcfg.d_model), dtype=np.float32)
    jg = jax.grad(lambda p: jssm.mlstm(p, jnp.asarray(x), jcfg)[0].sum())(jm)
    assert bool(jnp.isnan(jg["wf"]).any())
    p = {k: t.clone().requires_grad_() for k, t in tm.items()}
    ssm.mlstm(p, torch.from_numpy(x), tcfg)[0].sum().backward()
    for name, t in p.items():
        assert bool(torch.isfinite(t.grad).all()), name
    # the plain version at the reference's chunk of 256
    q = [t.requires_grad_() for t in torch_of(*gate_inputs(17, 2, 256, 2, 32))]
    y, _ = ops.mlstm_chunk(*q, chunk=256)
    y.sum().backward()
    for t in q:
        assert bool(torch.isfinite(t.grad).all())


def test_ops_mlstm_chunk_refuses_other_devices():
    # meta tensors take the fake kernel (a dry run's trace); mixed devices are refused
    q = torch.empty((1, 8, 2, 32), device="meta")
    g = torch.empty((1, 8, 2))
    with pytest.raises(ValueError, match="meta"):
        ops.mlstm_chunk(q, q, q, g, g)


# ---------------------------------------------------------------------------
# The mixers on reduced xlstm-350m (d_model 64, 4 heads: mLSTM hd 32, sLSTM hd 16)
# ---------------------------------------------------------------------------

@functools.cache
def mixer_case():
    """JAX-made mLSTM and sLSTM params (numpy) and their torch copies."""
    jcfg = jax_reduced(jax_get_config("xlstm_350m"))
    tcfg = reduced(get_config("xlstm_350m"))
    jm, _ = jssm.init_mlstm(jax.random.PRNGKey(3), jcfg)
    js, _ = jssm.init_slstm(jax.random.PRNGKey(4), jcfg)
    # the reference inits b_gates at zero: make them count
    js["b_gates"] = jnp.asarray(np.random.default_rng(9).standard_normal(
        js["b_gates"].shape, dtype=np.float32) * 0.5)
    tm = {k: torch.from_numpy(np.array(v)) for k, v in jm.items()}
    ts = {k: torch.from_numpy(np.array(v)) for k, v in js.items()}
    return jcfg, tcfg, jm, js, tm, ts


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def mlstm_state(seed, B, cfg):
    dk = int(cfg.mlstm_proj_factor * cfg.d_model)
    H, hd = cfg.n_heads, dk // cfg.n_heads
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, hd, hd), dtype=np.float32) * 0.1,
            rng.standard_normal((B, H, hd), dtype=np.float32))


@pytest.mark.parametrize("S,with_state", [(128, False), (128, True), (64, True), (16, False)])
def test_mlstm_matches_jax(S, with_state):
    """S = 128: the reference runs one chunk of 128, the port chunks of 64."""
    jcfg, tcfg, jm, _, tm, _ = mixer_case()
    x = np.random.default_rng(S).standard_normal((2, S, jcfg.d_model), dtype=np.float32)
    state = mlstm_state(10, 2, jcfg) if with_state else None
    jy, (jC, jn) = jssm.mlstm(jm, jnp.asarray(x), jcfg,
                              state=None if state is None else tuple(map(jnp.asarray, state)))
    ty, (tC, tn) = ssm.mlstm(tm, torch.from_numpy(x), tcfg,
                             state=None if state is None else tuple(torch_of(*state)))
    assert rel_err(ty.numpy(), jy) <= 1e-4
    assert rel_err(tC.numpy(), jC) <= 1e-4
    assert rel_err(tn.numpy(), jn) <= 1e-4


def test_mlstm_decode_step_matches_jax():
    jcfg, tcfg, jm, _, tm, _ = mixer_case()
    rng = np.random.default_rng(11)
    jstate = tuple(map(jnp.asarray, mlstm_state(12, 3, jcfg)))
    tstate = tuple(torch_of(*mlstm_state(12, 3, jcfg)))
    for _ in range(4):
        x = rng.standard_normal((3, 1, jcfg.d_model), dtype=np.float32)
        jy, jstate = jssm.mlstm_decode_step(jm, jnp.asarray(x), jcfg, jstate)
        ty, tstate = ssm.mlstm_decode_step(tm, torch.from_numpy(x), tcfg, tstate)
        assert rel_err(ty.numpy(), jy) <= 1e-4
        for t, j in zip(tstate, jstate):
            assert rel_err(t.numpy(), j) <= 1e-4


@pytest.mark.parametrize("S,with_state", [(16, True), (16, False), (1, True)])
def test_slstm_matches_jax(S, with_state):
    jcfg, tcfg, _, js, _, ts = mixer_case()
    rng = np.random.default_rng(13 + S)
    x = rng.standard_normal((2, S, jcfg.d_model), dtype=np.float32)
    state = None
    if with_state:
        state = (rng.standard_normal((2, jcfg.d_model), dtype=np.float32),
                 np.tanh(rng.standard_normal((2, jcfg.d_model), dtype=np.float32)))
    jy, (jc, jh) = jssm.slstm(js, jnp.asarray(x), jcfg,
                              state=None if state is None else tuple(map(jnp.asarray, state)))
    ty, (tc, th) = ssm.slstm(ts, torch.from_numpy(x), tcfg,
                             state=None if state is None else tuple(torch_of(*state)))
    assert rel_err(ty.numpy(), jy) <= 1e-4
    assert rel_err(tc.numpy(), jc) <= 1e-4
    assert rel_err(th.numpy(), jh) <= 1e-4


@pytest.mark.parametrize("mixer", ["mlstm", "slstm", "mamba"])
def test_init_matches_reference_layout_scales_and_dtypes(mixer):
    """bf16 model: projections in bf16, the gates' weights (mamba's
    ``dt_bias``, ``A_log`` and ``D``) in fp32 (as the reference); shapes
    equal and scales within sampling noise, constants equal."""
    arch = "jamba_1_5_large_398b" if mixer == "mamba" else "xlstm_350m"
    jcfg = dataclasses.replace(jax_reduced(jax_get_config(arch)), dtype="bfloat16")
    tcfg = dataclasses.replace(reduced(get_config(arch)), dtype="bfloat16")
    jp, _ = getattr(jssm, f"init_{mixer}")(jax.random.PRNGKey(0), jcfg)
    gen = torch.Generator().manual_seed(0)
    tp = getattr(ssm, f"init_{mixer}")(gen, tcfg)
    assert tp.keys() == jp.keys()
    for name, t in tp.items():
        j = np.asarray(jp[name].astype(jnp.float32))
        assert tuple(t.shape) == j.shape, name
        assert str(t.dtype).removeprefix("torch.") == str(jp[name].dtype), name
        if np.all(j == j.flat[0]) or name == "A_log":    # constants: equal
            np.testing.assert_allclose(t.float().numpy(), j, rtol=1e-6)
            continue
        sj, st = float(np.std(j)), float(t.float().std())
        assert abs(st - sj) <= 0.1 * sj + 1e-6, (name, st, sj)
