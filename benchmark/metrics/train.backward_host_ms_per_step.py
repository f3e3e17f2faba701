"""Host ms a training step in torch.autograd.grad (mip.backward) in the
traced tail: on the card the calling thread's wait while autograd's device
thread issues the backward, whose own spans this trace does not keep."""

from benchmark import spans


def read(res):
    return spans.ms_per_unit(res, 'mip.backward')
