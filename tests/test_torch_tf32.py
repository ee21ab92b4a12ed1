"""The f32 flash kernels' arithmetic, on the CPU.

On the card the flash forward (``csrc/flash_attention.cu``) and backward
(``csrc/flash_attention_bwd.cu``) take every product in f32 on the tensor
cores as 3xTF32 (``csrc/tf32.cuh``, ``csrc/flash_tf32.cuh``): a = hi + lo,
hi rounded to TF32 as ``cvt.rna`` does and lo the remainder, which the
tensor core reads with its low 13 bits dropped, and a·b = lo_a·hi_b +
hi_a·lo_b + hi_a·hi_b with fp32 sums (``mm3``, shared with the mLSTM
kernels' test). Here that arithmetic runs in plain PyTorch over attention's
forward (q·kᵀ and p·v over kv tiles of 32 keys with the online softmax, as
the kernel runs hd 192) and over its five backward products (q·kᵀ
recomputed, dO·vᵀ, pᵀ·dO, ds·k, dsᵀ·q, the sums over a kv group's query
heads inside the product, as the dk/dv kernel takes them) at
nemotron-4-340b's head dim 192, S = 256, 4 query heads over 2 kv heads. It
is held to float64 under the card's limits: the forward 2e-5 (abs and rel,
``tests/test_torch_cuda.py`` ``TOL``), each gradient elementwise
1e-4·(|ref| + rms(ref)) (``BWD_ELT_TOL``); the forward also to the JAX
package's reference at 2e-5. One TF32 product alone misses the forward's
limit (``-s`` prints both errors).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import flash_attention_ref as jax_flash_ref
from repro_torch.kernels.ref import NEG_INF, _visible

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_mlstm_split import mm1, mm3

B, S, H, K, HD = 1, 256, 4, 2, 192
TILE = 32          # keys per kv tile of the hd-192 forward
TOL = 2e-5         # the f32 forward's limit
BWD_ELT_TOL = 1e-4  # the f32 backward's elementwise limit
MASKS = [(True, None), (True, 48), (False, None)]


def inputs(seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in [(B, S, H, HD), (B, S, K, HD), (B, S, K, HD), (B, S, H, HD)])


def heads(q, k, v):
    """(B, K, G, S, hd) queries; (B, K, 1, S, hd) keys and values."""
    G = H // K
    return (q.reshape(B, S, K, G, HD).permute(0, 2, 3, 1, 4),
            k.permute(0, 2, 1, 3)[:, :, None], v.permute(0, 2, 1, 3)[:, :, None])


def rows(x):
    """(B, K, G, S, hd) -> (B, S, H, hd)."""
    return x.permute(0, 3, 1, 2, 4).reshape(B, S, H, HD)


def forward(q, k, v, causal, window, mm=mm3):
    """The forward kernel's arithmetic: per kv tile s = q·kᵀ·scale, masked to
    -1e30, the running max and sum, p·v added to the rescaled output; the
    output over the sum clamped at 1e-30, and each row's log-sum-exp."""
    qh, kh, vh = heads(q, k, v)
    visible = _visible(S, S, causal, window, q.device)
    m = torch.full(qh.shape[:-1], NEG_INF)
    l = torch.zeros(qh.shape[:-1])
    o = torch.zeros(qh.shape)
    for k0 in range(0, S, TILE):
        ok = visible[:, k0:k0 + TILE]
        s = mm(qh, kh[..., k0:k0 + TILE, :].transpose(-1, -2)) * HD ** -0.5
        s = torch.where(ok, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(ok, torch.exp(s - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + mm(p, vh[..., k0:k0 + TILE, :])
        m = m_new
    lse = (m + torch.log(l.clamp_min(1e-30))).reshape(B, H, S)
    return rows(o / l.clamp_min(1e-30)[..., None]), lse


def backward(q, k, v, o, do, lse, causal, window, mm=mm3):
    """The backward kernels' arithmetic from the forward's output and lse:
    p = exp(q·kᵀ·scale − lse), D = Σ dO·O, ds = p ⊙ (dO·vᵀ − D),
    dq = ds·k·scale, and dk = dsᵀ·q·scale, dv = pᵀ·dO with the kv group's
    query heads and rows in one product."""
    G = H // K
    qh, kh, vh = heads(q, k, v)
    oh, doh = (heads(t, k, v)[0] for t in (o, do))
    visible = _visible(S, S, causal, window, q.device)
    s = mm(qh, kh.transpose(-1, -2)) * HD ** -0.5
    p = torch.where(visible, torch.exp(s - lse.reshape(B, K, G, S)[..., None]), 0.0)
    ds = p * (mm(doh, vh.transpose(-1, -2)) - (doh * oh).sum(-1, keepdim=True))
    dq = rows(mm(ds, kh) * HD ** -0.5)

    def grouped(x):  # (B, K, G, S, n) -> (B, K, G·S, n)
        return x.reshape(B, K, G * S, x.shape[-1])

    dk = mm(grouped(ds).transpose(-1, -2), grouped(qh)) * HD ** -0.5
    dv = mm(grouped(p).transpose(-1, -2), grouped(doh))
    return dq, dk.permute(0, 2, 1, 3), dv.permute(0, 2, 1, 3)


def truth(q, k, v, do, causal, window):
    """Output and (dq, dk, dv) in float64 by autograd of plain attention."""
    q, k, v = (torch.from_numpy(t).double().requires_grad_() for t in (q, k, v))
    qh, kh, vh = heads(q, k, v)
    s = (qh @ kh.transpose(-1, -2)) * HD ** -0.5
    s = torch.where(_visible(S, S, causal, window, q.device), s, NEG_INF)
    o = rows(torch.softmax(s, dim=-1) @ vh)
    grads = torch.autograd.grad(o, (q, k, v), torch.from_numpy(do).double())
    return o.detach(), grads


def over_limit(got, want):
    """Largest |got − want| / (tol·|want| + tol·rms(want))."""
    limit = BWD_ELT_TOL * (want.abs() + want.square().mean().sqrt())
    return ((got.double() - want).abs() / limit).max().item()


@pytest.mark.parametrize("causal,window", MASKS)
def test_forward_in_3xtf32_holds_the_f32_limit(causal, window):
    q, k, v, _ = inputs()
    out, _ = forward(*(torch.from_numpy(t) for t in (q, k, v)), causal, window)
    o64, _ = truth(q, k, v, np.zeros_like(q), causal, window)
    torch.testing.assert_close(out.double(), o64, atol=TOL, rtol=TOL)
    jax_out = np.array(jax_flash_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     causal=causal, window=window))
    torch.testing.assert_close(out, torch.from_numpy(jax_out), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("causal,window", MASKS)
def test_backward_in_3xtf32_holds_the_f32_limit(causal, window):
    q, k, v, do = inputs(1)
    tq, tk, tv, tdo = (torch.from_numpy(t) for t in (q, k, v, do))
    out, lse = forward(tq, tk, tv, causal, window)
    got = backward(tq, tk, tv, out, tdo, lse, causal, window)
    _, want = truth(q, k, v, do, causal, window)
    for name, a, b in zip(("dq", "dk", "dv"), got, want, strict=True):
        assert a.shape == b.shape
        assert over_limit(a, b) <= 1.0, (name, over_limit(a, b))


def test_one_tf32_product_misses_the_forward_limit():
    q, k, v, _ = inputs()
    o64, _ = truth(q, k, v, np.zeros_like(q), True, None)
    err = {}
    for name, mm in (("3xTF32", mm3), ("1xTF32", mm1)):
        out, _ = forward(*(torch.from_numpy(t) for t in (q, k, v)), True, None, mm=mm)
        err[name] = (out.double() - o64).abs().max().item()
    print(f"\nforward max abs err at hd {HD}, S {S}: {err}")
    assert err["3xTF32"] <= TOL < err["1xTF32"]
