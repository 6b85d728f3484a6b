"""The window's seconds over the images completed in it, in ms."""


def read(run):
    if run.get("kind") != "render" or not run["attempted"]:
        return None
    return 1e3 * run["window_s"] / run["attempted"]
