"""The port's attention kernels against the JAX reference.

On the CPU the port's wrappers run the plain PyTorch versions
(``repro_torch.kernels.ref``); these are held against ``repro.kernels.ref``
and against the Pallas kernels run in interpret mode, on the same inputs
made with numpy. Tolerances: f32 2e-5, bf16 2e-2 (tests/test_kernels.py).

Which bf16 arithmetic each comparison holds: both ``flash_attention_ref``s
(and ``layers.sdpa``) cast the probabilities to q.dtype before p·v; both
``decode_attention_ref``s keep them in fp32; the Pallas kernels keep p·v
in fp32 throughout. The rows' log-sum-exp that the flash forward writes
for its backward has no JAX counterpart: ``flash_attention_lse_ref`` is
held to a float64 numpy log-sum-exp of the masked scores (1e-5), and the
backward's fp32 formulas fed it to the same formulas recomputing it
(1e-5). The CUDA kernels run only on the card (``tests/test_torch_cuda.py``;
the kernel check, ``python3 chip_smoke.py``, at the configurations' widths).
AdamW's wrapper on CPU leaves is its plain version to the bit and counts no
call; on meta and fake CUDA leaves its ops' fake implementations give the
shapes and dtypes of the plain version's outputs; a tree on two devices is
refused.
"""
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.ref import decode_attention_ref as jax_decode_ref
from repro.kernels.ref import flash_attention_ref as jax_flash_ref
from repro.models.layers import sdpa as jax_sdpa
from repro_torch.kernels import ops
from repro_torch.kernels.ref import (
    adamw_update_ref,
    decode_attention_ref,
    flash_attention_bwd_fp32_ref,
    flash_attention_lse_ref,
    flash_attention_ref,
)
from repro_torch.models.layers import resolve_device, sdpa
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.tree import leaves, map_tree

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def make(rng, shape, dtype):
    """The same values for both frameworks: numpy f32, rounded alike to bf16."""
    a = rng.standard_normal(shape, dtype=np.float32)
    return jnp.asarray(a).astype(dtype), torch.from_numpy(a).to(TORCH_DT[dtype])


def close(port, ref, dtype):
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


FLASH_SHAPES = [            # tests/test_kernels.py sweep, plus G = 3
    (1, 128, 2, 2, 64, 64, 64),      # MHA
    (2, 256, 4, 2, 64, 128, 64),     # GQA 2:1
    (1, 256, 8, 1, 32, 64, 128),     # MQA
    (2, 512, 4, 4, 128, 128, 128),   # bigger head_dim
    (1, 128, 15, 5, 64, 64, 64),     # smollm heads: G = 3, H = 15
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,K,hd,bq,bk", FLASH_SHAPES)
@pytest.mark.parametrize("causal,window", [(True, None), (False, None), (True, 128)])
def test_flash_ref_matches_jax(dtype, B, S, H, K, hd, bq, bk, causal, window):
    rng = np.random.default_rng(0)
    (qj, qt), (kj, kt), (vj, vt) = (make(rng, s, dtype) for s in
                                    [(B, S, H, hd), (B, S, K, hd), (B, S, K, hd)])
    port = ops.flash_attention(qt, kt, vt, causal=causal, window=window)
    close(port, jax_flash_ref(qj, kj, vj, causal=causal, window=window), dtype)
    close(port, pallas_flash(qj, kj, vj, causal=causal, window=window,
                             block_q=bq, block_k=bk, interpret=True), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None), (True, 64)])
def test_flash_ragged_s_matches_oracle(dtype, causal, window):
    """S = 200 is no multiple of any tile: held to the oracles only (the
    Pallas wrapper leaves padded keys unmasked)."""
    rng = np.random.default_rng(1)
    B, S, H, K, hd = 2, 200, 6, 2, 32
    (qj, qt), (kj, kt), (vj, vt) = (make(rng, s, dtype) for s in
                                    [(B, S, H, hd), (B, S, K, hd), (B, S, K, hd)])
    port = ops.flash_attention(qt, kt, vt, causal=causal, window=window)
    close(port, jax_flash_ref(qj, kj, vj, causal=causal, window=window), dtype)
    close(port, jax_sdpa(qj, kj, vj, causal=causal, window=window), dtype)


DECODE_SHAPES = [           # tests/test_kernels.py sweep, plus G = 3
    (2, 512, 8, 2, 64, 128),
    (3, 1024, 4, 4, 32, 256),
    (1, 256, 16, 2, 128, 64),
    (3, 256, 15, 5, 64, 128),        # smollm heads: G = 3
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,K,hd,bk", DECODE_SHAPES)
def test_decode_ref_matches_jax(dtype, B, S, H, K, hd, bk):
    rng = np.random.default_rng(2)
    (qj, qt), (kj, kt), (vj, vt) = (make(rng, s, dtype) for s in
                                    [(B, H, hd), (B, S, K, hd), (B, S, K, hd)])
    lens = np.asarray([S, max(1, S // 2), 7][:B], np.int32)
    port = ops.decode_attention(qt, kt, vt, torch.from_numpy(lens))
    close(port, jax_decode_ref(qj, kj, vj, jnp.asarray(lens)), dtype)
    close(port, pallas_decode(qj, kj, vj, jnp.asarray(lens), block_k=bk,
                              interpret=True), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_ragged_kv_len(dtype):
    """kv_len of 1, ragged values, the full cache, and past the cache (the
    non-rotating slot clamp: masks nothing); S is no multiple of a tile."""
    rng = np.random.default_rng(3)
    B, S, H, K, hd = 5, 100, 15, 5, 64
    (qj, qt), (kj, kt), (vj, vt) = (make(rng, s, dtype) for s in
                                    [(B, H, hd), (B, S, K, hd), (B, S, K, hd)])
    lens = np.asarray([1, 37, 64, S, S + 5], np.int32)
    port = ops.decode_attention(qt, kt, vt, torch.from_numpy(lens))
    close(port, jax_decode_ref(qj, kj, vj, jnp.asarray(lens)), dtype)
    mask = np.arange(S)[None, :] < lens[:, None]
    for b in range(B):  # each row equals attention over its valid prefix only
        n = int(mask[b].sum())
        alone = decode_attention_ref(qt[b:b + 1], kt[b:b + 1, :n], vt[b:b + 1, :n],
                                     torch.tensor([n], dtype=torch.int32))
        np.testing.assert_allclose(port[b].float().numpy(), alone[0].float().numpy(),
                                   atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,Skv,causal,window,q_offset,kv_len", [
    (32, 32, True, None, 0, None), (32, 32, False, 8, 0, None),
    (1, 40, False, None, 0, 17), (4, 40, True, None, 20, 24), (4, 40, True, 6, 30, 34),
])
def test_sdpa_oracle_matches_jax(dtype, Sq, Skv, causal, window, q_offset, kv_len):
    """The port's ``layers.sdpa`` (the model's plain oracle), with decode-style
    offsets and valid lengths, against JAX's; probabilities cast to q.dtype
    on both sides."""
    rng = np.random.default_rng(5)
    B, H, K, hd = 2, 6, 2, 16
    (qj, qt), (kj, kt), (vj, vt) = (make(rng, s, dtype) for s in
                                    [(B, Sq, H, hd), (B, Skv, K, hd), (B, Skv, K, hd)])
    kw = dict(causal=causal, window=window, q_offset=q_offset, kv_len=kv_len)
    close(sdpa(qt, kt, vt, **kw), jax_sdpa(qj, kj, vj, **kw), dtype)
    if Sq == Skv and not q_offset and kv_len is None:  # the flash oracle's case
        close(flash_attention_ref(qt, kt, vt, causal=causal, window=window),
              jax_sdpa(qj, kj, vj, **kw), dtype)


LSE_CASES = [(128, True, None), (200, True, 64), (200, False, None)]  # S = 200: ragged


def numpy_lse(q, k, causal, window):
    """(B, H, S): ln Σ exp(q·k·hd^-½) over each row's visible keys, float64."""
    B, S, H, hd = q.shape
    kk = np.repeat(k.astype(np.float64), H // k.shape[2], axis=2)
    s = np.einsum("bshd,bthd->bhst", q.astype(np.float64), kk) * hd ** -0.5
    rows, cols = np.arange(S)[:, None], np.arange(S)[None, :]
    visible = np.ones((S, S), bool)
    if causal:
        visible &= cols <= rows
    if window is not None:
        visible &= cols > rows - window
    s = np.where(visible, s, -np.inf)
    m = s.max(axis=-1, keepdims=True)
    return (m + np.log(np.exp(s - m).sum(axis=-1, keepdims=True)))[..., 0]


@pytest.mark.parametrize("S,causal,window", LSE_CASES)
def test_flash_lse_ref_matches_numpy_logsumexp(S, causal, window):
    rng = np.random.default_rng(S + (window or 0))
    q = rng.standard_normal((2, S, 6, 32), dtype=np.float32)
    k = rng.standard_normal((2, S, 2, 32), dtype=np.float32)
    got = flash_attention_lse_ref(torch.from_numpy(q), torch.from_numpy(k), causal=causal,
                                  window=window)
    assert got.dtype == torch.float32 and got.shape == (2, 6, S)
    np.testing.assert_allclose(got.numpy(), numpy_lse(q, k, causal, window), atol=1e-5, rtol=0)


@pytest.mark.parametrize("S,causal,window", LSE_CASES)
def test_flash_bwd_fp32_ref_from_given_lse_equals_recomputed(S, causal, window):
    g = torch.Generator().manual_seed(S)
    q, k, v, dout = (torch.randn(s, generator=g) for s in
                     [(2, S, 6, 32), (2, S, 2, 32), (2, S, 2, 32), (2, S, 6, 32)])
    out = flash_attention_ref(q, k, v, causal=causal, window=window)
    lse = flash_attention_lse_ref(q, k, causal=causal, window=window)
    given = flash_attention_bwd_fp32_ref(q, k, v, out, dout, causal=causal, window=window,
                                         lse=lse)
    recomputed = flash_attention_bwd_fp32_ref(q, k, v, out, dout, causal=causal, window=window)
    for a, b in zip(given, recomputed, strict=True):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


def test_cpu_tensors_use_plain_version_and_count_nothing():
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((1, 64, 6, 16), dtype=np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 64, 2, 16), dtype=np.float32))
    before = (ops.flash_attention.launches, ops.decode_attention.launches)
    assert torch.equal(ops.flash_attention(q, k, k, causal=True),
                       flash_attention_ref(q, k, k, causal=True))
    lens = torch.tensor([9], dtype=torch.int32)
    assert torch.equal(ops.decode_attention(q[:, 0], k, k, lens),
                       decode_attention_ref(q[:, 0], k, k, lens))
    assert (ops.flash_attention.launches, ops.decode_attention.launches) == before
    assert before == (0, 0)


def test_wrappers_refuse_other_devices():
    # meta tensors take the fake kernels (a dry run's trace); mixed devices are refused
    q = torch.empty((1, 8, 2, 16), device="meta")
    c = torch.empty((1, 8, 2, 16))
    with pytest.raises(ValueError, match="meta"):
        ops.flash_attention(q, c, c)
    with pytest.raises(ValueError, match="meta"):
        ops.decode_attention(q[:, 0], c, c, torch.empty((1,), device="meta"))


def test_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def _adamw_tree(device="cpu", p_dtype=torch.bfloat16, g_dtype=torch.float32):
    """(grads, state, params): a matrix (decayed), a 3-d stack and a 1-d leaf
    (not decayed), none of a multiple of 8 elements."""
    gen = torch.Generator().manual_seed(3)
    shapes = {"w": (5, 7), "stack": (2, 3, 9), "norm": (7,)}
    draw = lambda dt, s: {k: (torch.randn(v, generator=gen) * s).to(dt)  # noqa: E731
                          for k, v in shapes.items()}
    params, grads = draw(p_dtype, 1.0), draw(g_dtype, 0.3)
    state = adamw_init(params)
    state["mu"] = draw(torch.float32, 0.05)
    state["count"] = torch.tensor(2, dtype=torch.int32)
    if device != "cpu":  # shapes only (a CPU-only torch makes fake CUDA tensors, copies none)
        to = lambda t: map_tree(  # noqa: E731
            lambda x: torch.empty(x.shape, dtype=x.dtype, device=device), t)
        grads, state, params = to(grads), to(state), to(params)
    return grads, state, params


@pytest.mark.parametrize("compress", [None, "bf16"])
def test_adamw_cpu_leaves_take_the_plain_version_and_count_nothing(compress):
    grads, state, params = _adamw_tree()
    cfg = AdamWConfig(clip_norm=0.5, grad_compress=compress)
    before = ops.adamw_update.launches
    got = ops.adamw_update(grads, state, params, cfg, 0.7)
    want = adamw_update_ref(grads, state, params, cfg, 0.7)
    assert all(torch.equal(a, b) for a, b in zip(leaves(got), leaves(want), strict=True))
    assert ops.adamw_update.launches == before == 0


@pytest.mark.parametrize("device", ["meta", "fake_cuda"])
def test_adamw_fake_kernels_give_the_plain_versions_shapes(device):
    """The whole route through the ops' fake implementations (the sum, the
    finalize, the update), and the per-shard sum on its own."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    grads, state, params = _adamw_tree()
    want = adamw_update_ref(grads, state, params, AdamWConfig(), torch.tensor(0.5))
    mode = FakeTensorMode() if device == "fake_cuda" else contextlib.nullcontext()
    dev = "cuda" if device == "fake_cuda" else "meta"
    with mode:
        g, st, p = _adamw_tree(dev)
        got = ops.adamw_update(g, st, p, AdamWConfig(), torch.empty((), device=dev))
        leaf_sum = torch.ops.repro_torch.adamw_leaf_sumsq(g["w"], False)
    assert [(t.shape, t.dtype, t.device.type) for t in leaves(got)] == [
        (t.shape, t.dtype, dev.split(":")[0]) for t in leaves(want)]
    assert (leaf_sum.shape, leaf_sum.dtype) == ((), torch.float32)
    assert ops.adamw_update.launches == 0


def test_adamw_refuses_a_tree_on_two_devices():
    grads, state, params = _adamw_tree()
    params["w"] = params["w"].to("meta")
    with pytest.raises(ValueError, match="meta"):
        ops.adamw_update(grads, state, params, AdamWConfig())
