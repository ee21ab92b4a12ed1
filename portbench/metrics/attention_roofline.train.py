"""The flash attention kernels' share of their roofline in the traced steps,
in percent: the least time of every forward and backward launch
(portbench.arith.flash_bound_s at the microbatch's shape, the launches
counted by the program's kernel ops) over the device time of the kernels
named ``flash_*``."""
from portbench import arith
from portbench.trace import seconds_of


def read(rec):
    t = rec["trace"]
    if rec["kind"] != "train" or not t:
        return None
    sec = seconds_of(t["kernel_s"], "flash_")
    n = rec["flash_launches"]
    if sec <= 0 or not n["fwd"]:
        return None
    c, tr = rec["config"], rec["traffic"]
    b = tr["batch"] // tr["microbatches"]
    bound = (n["fwd"] * arith.flash_bound_s(c, b, tr["seq"], backward=False)
             + n["bwd"] * arith.flash_bound_s(c, b, tr["seq"], backward=True))
    return 100.0 * bound / sec
