"""Device-busy ms a step: the union of the device operations' intervals
in the traced window over its steps."""


def read(m):
    t = m["trace"]
    return 1e3 * t["busy_s"] / t["steps"] if t and t["device_events"] else None
