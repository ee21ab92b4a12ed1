"""The whole decode step's share of the card's peak, in percent: the least
time of every decode step in the window (the larger of its operations over
the peak and its bytes over the HBM rate, portbench.arith.decode_step_bound_s)
over the window."""
from portbench import arith


def read(rec):
    if rec["kind"] != "serve":
        return None
    c, tr = rec["config"], rec["traffic"]
    per_job = sum(arith.decode_step_bound_s(c, tr["batch"], pos)
                  for pos in range(rec["steps_per_job"]))
    return 100.0 * rec["jobs"] * per_job / rec["window_s"]
