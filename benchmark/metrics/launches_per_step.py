"""Device operations (kernels, copies, fills) a step in the traced window."""


def read(m):
    t = m["trace"]
    return t["device_events"] / t["steps"] if t and t["device_events"] else None
