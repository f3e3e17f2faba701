"""Host ms a training step in the forward and the loss terms (mip.model,
the launches of the forward's kernels included) in the traced tail."""

from benchmark import spans


def read(res):
    return spans.ms_per_unit(res, 'mip.model')
