"""img_per_s: every image finished in the window over the window's
seconds (host clock; a call ends with its results on the host)."""


def read(run):
    return sum(c.items for c in run.calls) / run.window_s
