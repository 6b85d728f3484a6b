"""Process start to the first timed image or step, in s: imports, the
kernels' build or load, the scene, the target and the warm-up."""


def read(run):
    return run["setup_s"]
