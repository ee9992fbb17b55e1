"""Host ms of the task draw a step: the benchmark's span around
draw_step_inputs in the traced window (the draw and the queued copy of
its tensors to the card)."""


def read(m):
    spans = (m["trace"] or {}).get("spans", {}).get("draw_step_inputs")
    return 1e3 * sum(spans) / len(spans) if spans else None
