"""Device-idle ms a step while the host's innermost program span lies
inside draw (the task draw and its copy): the traced window's idle time
cut at the program's span boundaries."""


def read(m):
    got = (m["trace"] or {}).get("idle_by_span")
    if got is None:
        return None
    return 1e3 * sum(v for k, v in got.items() if k.split("/")[0] == "draw") / m["trace"]["steps"]
