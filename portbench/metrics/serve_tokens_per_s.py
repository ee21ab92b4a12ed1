"""Every generated token of every request completed in the window over the
window's wall time (offline batch throughput: prompt steps cost time and
are not counted)."""


def read(rec):
    return rec["tokens"] / rec["window_s"] if rec["kind"] == "serve" else None
