"""Host ms a frame in the chunks' forwards (mip.model, their kernels'
launches included) in the traced tail."""

from benchmark import spans


def read(res):
    return spans.ms_per_unit(res, 'mip.model')
