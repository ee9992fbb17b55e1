"""MB (1e6 bytes) a step that the program's counter h2d_bytes counts
(the tensors train/loop.py::to_device sends to the card) over the traced
steps."""


def read(m):
    got = ((m["trace"] or {}).get("counters") or {}).get("h2d_bytes")
    return got / 1e6 / m["trace"]["steps"] if got else None
