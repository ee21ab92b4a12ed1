"""Every token trained in the window's steps over the window's wall time."""


def read(rec):
    return rec["tokens"] / rec["window_s"] if rec["kind"] == "train" else None
