"""The share of the device window (``traced_steps`` whole steps after the
measured window, kernels recorded without the host's operations) in which
no kernel, copy or memset ran on the device, in percent."""


def read(lc):
    win = lc["window"]
    if win.seconds <= 0:
        return None
    return 100.0 * (1.0 - win.busy_ns() / (win.t1 - win.t0))
