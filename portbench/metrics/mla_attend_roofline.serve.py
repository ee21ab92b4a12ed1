"""The absorbed latent-attention core's share of its roofline in the traced
serving jobs, in percent: the least time of every ``mla.attend`` span of the
program (portbench.arith_mla.attend_bound_s at the span's ``batch`` and
``pos + 1`` cached tokens: the cached latent and rotary keys read, the scores
and the probabilities' sum of latents) over those spans' device time. In a
graphed step the spans are the replays' (``tracing.Capture``)."""
from portbench import arith_mla
from portbench import spans as S


def read(rec):
    spans = S.named(S.recorded(rec, "serve") or [], "mla.attend")
    ms = sum(s["device_ms"] or 0.0 for s in spans)
    if ms <= 0 or "kv_lora_rank" not in rec["config"]:
        return None
    bound = sum(arith_mla.attend_bound_s(rec["config"], s["attrs"]["batch"],
                                         s["attrs"]["pos"] + 1) for s in spans)
    return 100.0 * bound / (ms / 1e3)
