"""% of device busy time in the traced tail that the frame's work bound
(the larger of FLOP over the peak and bytes over HBM bandwidth, counted
from the configuration's shapes in work.py) accounts for."""

from benchmark import readers


def read(res):
    return readers.roofline_share(res)
