"""Device ms a frame in kernels of PyTorch's own libraries (ATen, cuBLAS,
cuDNN, CUTLASS, CUB, memcpy, memset: the names torch_library.txt lists) in
the traced tail."""

from benchmark import readers

LIBRARY = readers.patterns('torch_library')


def read(res):
    return readers.device_ms_per_unit(res, LIBRARY, matching=True)
