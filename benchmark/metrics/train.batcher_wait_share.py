"""% of the measured window spent in next(system.batcher)."""


def read(res):
    return 100.0 * res['window']['batcher_wait_s'] / res['window']['seconds']
