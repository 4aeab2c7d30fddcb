"""idle_share.query: the share of the traced calls' host-clock wall
in which the device ran nothing (1 - the union of its kernel, copy and
set intervals over the wall), in percent."""


def read(run):
    t = run.trace
    if t is None or t.wall_s <= 0 or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_us() / 1e6 / t.wall_s)
