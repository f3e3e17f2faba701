"""% of the chip's peak that the step's MLP FLOP (work.py) reach over the
traced tail's wall time."""

from benchmark import readers


def read(res):
    return readers.mfu(res)
