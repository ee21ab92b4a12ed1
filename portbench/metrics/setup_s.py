"""Set-up seconds: from the process's start to the window's, covering imports,
the kernels' build or load, the weights, the first steps or the warm job."""


def read(rec):
    return rec["setup_s"]
