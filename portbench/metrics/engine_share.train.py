"""Percent of the window outside the step payloads: the engine's workflow,
its tasks and the feed. A payload span wraps the program's step and ends in
a synchronise."""


def read(rec):
    if rec["kind"] != "train":
        return None
    return 100.0 * (1.0 - rec["payload_s"] / rec["window_s"])
