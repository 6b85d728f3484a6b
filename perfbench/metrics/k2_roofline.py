"""K2's share of its roofline, in % (``perfbench/work/k2.py``)."""

from perfbench.roofline import share


def read(run):
    return share(run, "k2")
