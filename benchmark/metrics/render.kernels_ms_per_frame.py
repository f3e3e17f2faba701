"""Device ms a frame in every kernel that torch_library.txt does not list,
the port's own (csrc/), in the traced tail."""

from benchmark import readers

LIBRARY = readers.patterns('torch_library')


def read(res):
    return readers.device_ms_per_unit(res, LIBRARY, matching=False)
