"""The window's seconds over its fit steps, in ms."""


def read(run):
    if run.get("kind") != "fit" or not run["steps"]:
        return None
    return 1e3 * run["window_s"] / run["steps"]
