"""device.idle_share: the share of the profiled queue in which no kernel,
copy or set ran on the card (%)."""


def read(w):
    if w.profile is None:
        return None
    idle = w.profile.idle()
    return None if idle is None else 100.0 * idle[2]
