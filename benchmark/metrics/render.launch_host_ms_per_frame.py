"""Host ms a frame in the port's kernel launches (mip.launch: the ctypes
call and its route-counter reads) in the traced tail."""

from benchmark import spans


def read(res):
    return spans.ms_per_unit(res, 'mip.launch')
