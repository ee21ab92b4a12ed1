"""The whole decode step's share of the card's peak in a latent-attention
serving cell, in percent: the least time of every decode step in the window
(the larger of its operations over the peak and its bytes over the HBM rate,
portbench.arith_mla.decode_step_bound_s: every held weight read once, the
latent cache, the logits; the routed experts' operations for the assignments
a held expert can expect) over the window."""
from portbench import arith_mla


def read(rec):
    c = rec["config"]
    if rec["kind"] != "serve" or "kv_lora_rank" not in c:
        return None
    B = rec["traffic"]["batch"]
    per_job = sum(arith_mla.decode_step_bound_s(c, B, pos) for pos in range(rec["steps_per_job"]))
    return 100.0 * rec["jobs"] * per_job / rec["window_s"]
