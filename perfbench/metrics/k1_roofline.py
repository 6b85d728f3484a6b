"""K1's share of its roofline, in % (``perfbench/work/k1.py``)."""

from perfbench.roofline import share


def read(run):
    return share(run, "k1")
