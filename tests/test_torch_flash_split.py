"""The 3xTF32 flash forward's kv split for short Sq, on the CPU.

``repro_torch.kernels.flash_attention.split_plan`` cuts the kv axis into
ranges from the shapes alone when the q tiles give too few blocks and no
mask is asked for (whisper's cross-attention from a few decoder tokens to
its 1500 frames). On the card each range's block writes its rows'
normalised partial output o_z and log-sum-exp lse_z, and a second kernel
merges them: o = Σ_z exp(lse_z − lse)·o_z, lse = ln Σ_z exp(lse_z).
``split_then_merge`` renders that in plain PyTorch (it is not on the port's
path) and is held against the plain version and the JAX reference at f32
2e-5, and its lse against ``flash_attention_lse_ref`` at 1e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import flash_attention_ref as jax_flash_ref
from repro_torch.kernels.flash_attention import SPLIT_KEYS, TARGET_BLOCKS, split_plan
from repro_torch.kernels.ref import flash_attention_lse_ref, flash_attention_ref

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 2e-5
LSE_TOL = 1e-4


def split_then_merge(q, k, v, n_split, split_len):
    """The forward as the split kernels compute it, unmasked: per range of
    ``split_len`` keys the rows' normalised output and log-sum-exp in fp32,
    then the merge weighting each range by exp(lse_z − lse)."""
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    qg = q.float().reshape(B, Sq, K, G, hd)
    outs, lses = [], []
    for z in range(n_split):
        kz, vz = (t[:, z * split_len:(z + 1) * split_len].float() for t in (k, v))
        s = torch.einsum("bskgh,btkh->bkgst", qg, kz) * hd ** -0.5
        lse = torch.logsumexp(s, dim=-1)
        outs.append(torch.einsum("bkgst,btkh->bkgsh", torch.exp(s - lse[..., None]), vz))
        lses.append(lse)
    lse_z = torch.stack(lses)
    lse = torch.logsumexp(lse_z, dim=0)
    out = (torch.exp(lse_z - lse)[..., None] * torch.stack(outs)).sum(dim=0)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd), lse.reshape(B, H, Sq)


@pytest.mark.parametrize("B,Sq,Skv,H,hd,masked,plan", [
    (2, 1, 1500, 20, 64, False, (6, 256)),     # whisper cross from one token: 240 blocks
    (2, 37, 1500, 20, 64, False, (6, 256)),    # ... from 37, under one q tile
    (2, 64, 1500, 20, 64, False, (6, 256)),    # ... from 64: the f32 decode-vs-forward check
    (2, 512, 1500, 20, 64, False, (1, 1536)),  # 320 blocks already: one range
    (2, 1, 1500, 20, 64, True, (1, 1536)),     # a mask: never split
    (2, 37, 300, 8, 128, False, (2, 160)),     # hd 128: 32-key tiles
    (1, 1, 8, 12, 192, False, (1, 32)),        # fewer keys than SPLIT_KEYS: one range
])
def test_split_plan_at_known_shapes(B, Sq, Skv, H, hd, masked, plan):
    assert split_plan(B, Sq, Skv, H, hd, masked) == plan


@pytest.mark.parametrize("Skv", [1, 63, 64, 300, 1500, 4097])
@pytest.mark.parametrize("hd", [16, 64, 128, 192])
def test_split_plan_covers_the_keys_in_whole_tiles(Skv, hd):
    tile = 32 if hd >= 128 else 64
    n_split, split_len = split_plan(1, 1, Skv, 2, hd, False)
    assert split_len % tile == 0
    assert (n_split - 1) * split_len < Skv <= n_split * split_len
    assert n_split <= -(-Skv // SPLIT_KEYS)
    assert n_split <= -(-TARGET_BLOCKS // 2)


@pytest.mark.parametrize("B,Sq,Skv,H,K,hd", [(2, 37, 1500, 20, 20, 64), (1, 5, 700, 12, 1, 192),
                                          (2, 16, 300, 8, 2, 128)])
def test_split_then_merge_matches_plain_version_and_jax(B, Sq, Skv, H, K, hd):
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in [(B, Sq, H, hd), (B, Skv, K, hd), (B, Skv, K, hd)])
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    n_split, split_len = split_plan(B, Sq, Skv, H, hd, False)
    assert n_split > 1
    out, lse = split_then_merge(tq, tk, tv, n_split, split_len)
    torch.testing.assert_close(out, flash_attention_ref(tq, tk, tv, causal=False),
                               atol=TOL, rtol=TOL)
    jax_out = np.array(jax_flash_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     causal=False))
    torch.testing.assert_close(out, torch.from_numpy(jax_out), atol=TOL, rtol=TOL)
    torch.testing.assert_close(lse, flash_attention_lse_ref(tq, tk, causal=False),
                               atol=LSE_TOL, rtol=0)
