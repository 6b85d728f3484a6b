"""Device kernels launched per fit step in the traced window."""


def read(run):
    if run.get("kind") != "fit" or not run.get("trace") or not run["steps"]:
        return None
    return run["trace"]["n_kernels"] / run["steps"]
