"""Percent of the traced training stretch in which nothing ran on the card."""


def read(rec):
    t = rec["trace"]
    if rec["kind"] != "train" or not t or not t["kernels"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
