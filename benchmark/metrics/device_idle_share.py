"""The share of the traced window in which no device operation ran, in %."""


def read(m):
    t = m["trace"]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"]) if t and t["device_events"] else None
