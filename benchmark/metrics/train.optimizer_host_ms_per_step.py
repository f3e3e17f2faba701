"""Host ms a training step in the Adam update (mip.adam) in the traced
tail."""

from benchmark import spans


def read(res):
    return spans.ms_per_unit(res, 'mip.adam')
