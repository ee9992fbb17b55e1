"""The kernels' share of the card's peak while they run, in %: the
analytic matrix-product FLOPs of a step (flops.py) over its device-busy
seconds, over the dense bf16 peak."""


def read(m):
    t = m["trace"]
    if not (t and t["busy_s"] and m["peak_flops"]):
        return None
    return 100.0 * m["flops_per_step"] * t["steps"] / t["busy_s"] / m["peak_flops"]
