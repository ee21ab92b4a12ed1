"""The split decode kernel's host plan and merge arithmetic, on the CPU.

``repro_torch.kernels.decode_attention.split_plan`` cuts the kv axis into
ranges from the shapes alone. On the card each block computes its range's
running max m, sum l and accumulator acc, and a second kernel merges the
ranges by the log-sum-exp rule. ``split_then_combine`` renders that
arithmetic in plain PyTorch (it is not on the port's path) and is held
against the plain version and the JAX reference at f32 2e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import decode_attention_ref as jax_decode_ref
from repro_torch.kernels.decode_attention import SPLIT_KEYS, TARGET_BLOCKS, TILE, split_plan
from repro_torch.kernels.ref import NEG_INF, decode_attention_ref

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)


def split_then_combine(q, k_cache, v_cache, kv_len, n_split, split_len):
    """Decode attention as the CUDA kernels compute it: per range of
    ``split_len`` keys a partial (m, l, acc) in fp32, an empty range giving
    (-1e30, 0, 0), then one merge weighting each range by exp(m - max m)."""
    B, H, hd = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    G = H // K
    qg = q.float().reshape(B, K, G, hd) * hd ** -0.5
    n = kv_len.clamp(0, S)
    ms, ls, accs = [], [], []
    for s in range(n_split):
        lo, hi = s * split_len, min((s + 1) * split_len, S)
        valid = (torch.arange(lo, hi)[None, :] < n[:, None])[:, None, None, :]
        logits = torch.einsum("bkgh,bskh->bkgs", qg, k_cache[:, lo:hi].float())
        logits = torch.where(valid, logits, NEG_INF)
        m = logits.amax(dim=-1)
        p = torch.where(valid, torch.exp(logits - m[..., None]), 0.0)
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("bkgs,bskh->bkgh", p, v_cache[:, lo:hi].float()))
    m, l, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)
    w = torch.exp(m - m.amax(dim=0))
    out = (acc * w[..., None]).sum(dim=0) / torch.clamp((l * w).sum(dim=0), min=1e-30)[..., None]
    return out.reshape(B, H, hd).to(q.dtype)


@pytest.mark.parametrize("B,K,S,plan", [
    (4, 5, 64, (1, 64)),        # smollm serving: one range, no scratch, no merge
    (32, 5, 64, (1, 64)),
    (4, 5, 256, (1, 256)),      # up to SPLIT_KEYS keys stay one range
    (8, 5, 2048, (7, 320)),     # the kernel check's ragged case: 280 blocks
    (1, 5, 8192, (32, 256)),    # one long request: 160 blocks
    (1, 8, 2048, (8, 256)),
])
def test_split_plan_at_known_shapes(B, K, S, plan):
    assert split_plan(B, K, S) == plan


@pytest.mark.parametrize("B", [1, 2, 8, 64])
@pytest.mark.parametrize("K", [1, 5, 8])
@pytest.mark.parametrize("S", [1, 63, 64, 65, 256, 257, 1000, 4096, 32768])
def test_split_plan_covers_the_cache_in_whole_tiles(B, K, S):
    n_split, split_len = split_plan(B, K, S)
    assert split_len % TILE == 0
    assert n_split * split_len >= S > (n_split - 1) * split_len  # no empty range by shape
    assert 1 <= n_split <= -(-S // SPLIT_KEYS)
    assert (n_split == 1) == (S <= SPLIT_KEYS or B * K >= TARGET_BLOCKS)


@pytest.mark.parametrize("B,S,H,K,hd,lens", [
    (4, 2048, 15, 5, 64, [1, 300, 2048, 5000]),  # ranges past kv_len, kv_len 1 and > S
    (1, 8192, 15, 5, 64, [8191]),
    (2, 1000, 16, 2, 128, [999, 17]),            # G = 8, ragged S
    (3, 700, 16, 1, 32, [700, 1, 650]),          # G = 16
    (4, 64, 15, 5, 64, [63, 63, 63, 63]),        # one range
])
def test_split_then_combine_matches_plain_version_and_jax(B, S, H, K, hd, lens):
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal(s, dtype=np.float32)
               for s in [(B, H, hd), (B, S, K, hd), (B, S, K, hd)])
    kv_len = np.asarray(lens, np.int32)
    n_split, split_len = split_plan(B, K, S)
    got = split_then_combine(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                             torch.from_numpy(kv_len), n_split, split_len)
    plain = decode_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), torch.from_numpy(kv_len))
    ref = jax_decode_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kv_len))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("n_split,split_len", [(1, 1024), (2, 512), (4, 256), (16, 64)])
def test_merge_does_not_depend_on_the_cut(n_split, split_len):
    """Any cut of the kv axis into whole tiles gives the same output."""
    rng = np.random.default_rng(12)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               for s in [(3, 6, 64), (3, 1000, 2, 64), (3, 1000, 2, 64)])
    kv_len = torch.tensor([1000, 129, 3], dtype=torch.int32)
    got = split_then_combine(q, k, v, kv_len, n_split, split_len)
    np.testing.assert_allclose(got.numpy(), decode_attention_ref(q, k, v, kv_len).numpy(),
                               atol=2e-5, rtol=2e-5)
