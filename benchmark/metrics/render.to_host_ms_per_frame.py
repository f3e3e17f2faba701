"""Host ms a frame in the copy of its outputs to the host (mip.to_host,
which waits for the card to drain) in the traced tail."""

from benchmark import spans


def read(res):
    return spans.ms_per_unit(res, 'mip.to_host')
