"""syncs_per_call.batch16: the program's "sync: ..." spans a call,
averaged over the traced calls: each holds one call that waits for the
device, so this is the number of host syncs of a call."""

PREFIX = "sync: "


def read(run):
    t = run.trace
    if t is None:
        return None
    n = sum(1 for name, _, _ in t.spans if name.startswith(PREFIX))
    return n / t.calls if n else None
