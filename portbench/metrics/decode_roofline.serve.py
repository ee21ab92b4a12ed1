"""The decode attention kernels' share of their roofline in the traced jobs,
in percent: the least time of every call (portbench.arith.
decode_attention_bound_s, one a step and attention layer, the cache filled
to the step's position) over the device time of the kernels named
``decode_*``. Nothing is read unless the program's launch count is that."""
from portbench import arith
from portbench.trace import seconds_of


def read(rec):
    t = rec["trace"]
    if rec["kind"] != "serve" or not t:
        return None
    c, tr = rec["config"], rec["traffic"]
    n_attn = sum(e.startswith("attn") for e in arith.entries(c))
    steps = rec["steps_per_job"]
    sec = seconds_of(t["kernel_s"], "decode_")
    if sec <= 0 or rec["decode_launches"] != rec["trace_jobs"] * steps * n_attn:
        return None
    per_job = sum(arith.decode_attention_bound_s(c, tr["batch"], pos + 1) for pos in range(steps))
    return 100.0 * rec["trace_jobs"] * n_attn * per_job / sec
