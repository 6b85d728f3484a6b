"""Host time inside ``render()`` before it returns, per image, in ms: the
entry, the route and the host tables, on the benchmark's clock."""


def read(run):
    if run.get("kind") != "render" or not run["host_s"]:
        return None
    return 1e3 * sum(run["host_s"]) / len(run["host_s"])
