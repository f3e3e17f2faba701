"""Host ms a training step in make_train_many's own work (mip.dispatch
less its steps' mip.model, mip.backward and mip.adam: moving the stack,
seeding each step's generator, slicing its rows, the aux sums) in the
traced tail."""

from benchmark import spans


def read(res):
    return spans.ms_per_unit(res, 'mip.dispatch',
                             ('mip.model', 'mip.backward', 'mip.adam'))
