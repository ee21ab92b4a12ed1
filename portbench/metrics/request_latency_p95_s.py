"""The 95th percentile of every completed request's latency: from its job's
submission to ``serve`` returning (numpy's linear interpolation)."""
import numpy as np


def read(rec):
    if rec["kind"] != "serve" or not rec["latencies_s"]:
        return None
    return float(np.percentile(rec["latencies_s"], 95))
