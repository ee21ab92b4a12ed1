"""Device milliseconds per training step: every device activity of the traced
steps, summed, over their number."""


def read(rec):
    t = rec["trace"]
    if rec["kind"] != "train" or not t or not t["kernels"]:
        return None
    return 1e3 * sum(t["kernel_s"].values()) / rec["trace_steps"]
