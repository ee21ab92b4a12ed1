"""The JAX package's whisper decode with its cross-attention cache filled.

The reference's ``init_cache`` makes every layer's ``cross_k`` / ``cross_v``
zeros and no function writes them, so its decode attends over zeros. The
port's tests fill them by hand from the reference's own encoder before
holding the port's decode to its ``decode_step``.
"""
import jax.numpy as jnp

from repro.models import layers as JL
from repro.models import model as JM


def jax_cache_filled_by_hand(jcfg, jparams, embeds, batch, seq_len):
    """JAX's ``init_cache`` with every layer's ``cross_k`` / ``cross_v``
    written from JAX's own ``encode(embeds) @ wk`` / ``@ wv``, the frames
    cast to the config's dtype."""
    enc = JM.encode(jparams, jcfg, jnp.asarray(embeds, JL.dtype_of(jcfg)))
    cache = JM.init_cache(jcfg, batch, seq_len)
    F, K, hd = jcfg.enc_frames, jcfg.n_kv_heads, jcfg.hd
    for blk, c in zip(jparams["blocks"], cache):
        for name, w in (("cross_k", "wk"), ("cross_v", "wv")):
            c[name] = jnp.stack([(enc @ blk["cross"][w][r]).reshape(batch, F, K, hd)
                                 for r in range(jcfg.n_repeats)])
    return cache
