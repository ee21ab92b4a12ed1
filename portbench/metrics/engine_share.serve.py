"""Percent of the window outside the program's decode loops: the engine's job,
the cache's set-up, the handing back of tokens. A decode loop's span is the
request's ``latency_s`` in the program's summary (its p99 over one request)."""


def read(rec):
    if rec["kind"] != "serve":
        return None
    return 100.0 * (1.0 - rec["decode_s"] / rec["window_s"])
