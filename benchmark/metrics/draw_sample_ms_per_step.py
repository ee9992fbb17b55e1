"""Host ms a step of the program's span draw.sample (the task params and
both point-set kinds, drawn on the host) in the traced window."""


def read(m):
    got = ((m["trace"] or {}).get("program_spans") or {}).get("draw.sample")
    return 1e3 * sum(got) / m["trace"]["steps"] if got else None
