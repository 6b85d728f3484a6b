"""K7's share of its roofline, in % (``perfbench/work/k7.py``)."""

from perfbench.roofline import share


def read(run):
    return share(run, "k7")
