"""Model FLOPs of the window's steps over the window and the bf16 peak, in
percent (portbench.arith.train_model_flops: recomputation not counted)."""
from portbench import arith


def read(rec):
    if rec["kind"] != "train":
        return None
    tr = rec["traffic"]
    flops = rec["steps"] * arith.train_model_flops(rec["config"], tr["batch"], tr["seq"])
    return 100.0 * flops / (rec["window_s"] * arith.PEAK_FLOPS[rec["config"]["dtype"]])
