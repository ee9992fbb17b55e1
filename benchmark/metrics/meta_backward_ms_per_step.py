"""Host ms a step of the program's span maml.meta_backward (the
second-order backward of the mean meta-loss, remat's recompute inside)
in the traced window."""


def read(m):
    got = ((m["trace"] or {}).get("program_spans") or {}).get("maml.meta_backward")
    return 1e3 * sum(got) / m["trace"]["steps"] if got else None
