"""The share of the traced window in which no operation ran on the
device, in %, in a render cell."""

from perfbench.tracing import idle_share


def read(run):
    return idle_share(run, "render")
