"""Device milliseconds per decode step: every device activity of the traced
jobs, summed, over their decode steps (prompt steps included)."""


def read(rec):
    t = rec["trace"]
    if rec["kind"] != "serve" or not t or not t["kernels"]:
        return None
    return 1e3 * sum(t["kernel_s"].values()) / (rec["trace_jobs"] * rec["steps_per_job"])
