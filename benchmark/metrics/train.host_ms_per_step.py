"""Host ms a training step inside make_train_many's calls (before the
synchronise), over the measured window: the host's pacing of the card."""


def read(res):
    return 1e3 * res['window']['dispatch_host_s'] / res['window']['steps']
