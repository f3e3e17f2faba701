"""% of the traced tail with no operation on the card."""

from benchmark import readers


def read(res):
    return readers.idle_share(res)
