"""Host ms a step of the program's span step (step_core: the host's time
to issue the meta-step to the card) in the traced window."""


def read(m):
    got = ((m["trace"] or {}).get("program_spans") or {}).get("step")
    return 1e3 * sum(got) / m["trace"]["steps"] if got else None
