"""Host ms a step of the program's span draw.to_device (pinning the
draws and queueing their copies to the card) in the traced window."""


def read(m):
    got = ((m["trace"] or {}).get("program_spans") or {}).get("draw.to_device")
    return 1e3 * sum(got) / m["trace"]["steps"] if got else None
