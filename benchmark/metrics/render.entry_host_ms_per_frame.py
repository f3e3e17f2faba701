"""Host ms a frame in the render's own work (mip.frame less mip.model and
mip.to_host: the rays, the chunk loop's slicing, padding and assembly) in
the traced tail."""

from benchmark import spans


def read(res):
    return spans.ms_per_unit(res, 'mip.frame', ('mip.model', 'mip.to_host'))
