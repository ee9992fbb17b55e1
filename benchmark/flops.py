"""The matrix-product FLOPs and the byte floor of one outer step, from the
configuration's shapes alone.

A SIREN of `layers` hidden layers of `width` over `in_dim` coordinates
costs 2 (in_dim width + (layers - 1) width^2 + width) FLOPs of matrix
products a point and a stream. A point kind's loss carries `streams`
streams through the same products: 1 for the value, 1 + d + h for the
value, its d first derivatives and the h second derivatives the loss
needs (the configuration's "flop_model" gives each kind's points and
streams). A backward pass costs twice the products of the pass it
reverses (the gradients of both operands, as the input scale is a
parameter); differentiating a backward pass again costs twice that.

Second-order MAML, per task: K inner steps, each the inner loss (1), its
gradient kept differentiable (2), the outer loss after the step (1), and
the meta-gradient back through all three (6 for the inner loss and its
gradient, 2 for the outer loss); then the loss after the last step and
the outer loss on its last set, forward only: K (9 F_in + 3 F_out) +
F_in + F_out.

Recomputation (remat) is not work the algorithm needs and is not
counted; nor are the elementwise operations.
"""


def per_point(config: dict) -> int:
    """Matrix-product FLOPs of one stream through the field at one point."""
    hp = {**config["settings"], **config["flags"]}
    width, layers = int(hp["model.layer_size"]), int(hp["model.num_layers"])
    return 2 * (config["in_dim"] * width + (layers - 1) * width * width + width)


def set_flops(config: dict, kinds) -> int:
    """One loss forward over one point set of one task."""
    return sum(k["points"] * k["streams"] for k in kinds) * per_point(config)


def step_flops(config: dict) -> int:
    """Matrix-product FLOPs of one outer step."""
    hp = {**config["settings"], **config["flags"]}
    model = config["flop_model"]
    f_in = set_flops(config, model["kinds"])
    if config["algorithm"] != "maml":
        raise ValueError(f"no FLOP count for {config['algorithm']!r}")
    k, tasks = int(hp["maml.inner_steps"]), int(hp["maml.bsize"])
    f_out = set_flops(config, model.get("outer_kinds", model["kinds"]))
    return tasks * (k * (9 * f_in + 3 * f_out) + f_in + f_out)


def meta_parameters(config: dict) -> int:
    """The init's parameter count, the learned LRs' with MAML."""
    hp = {**config["settings"], **config["flags"]}
    width, layers = int(hp["model.layer_size"]), int(hp["model.num_layers"])
    d = config["in_dim"]
    n = d * width + (layers - 1) * width * width + width + layers * width + 1 + d + 1
    if config["algorithm"] == "maml":
        n *= 1 + int(hp["maml.inner_steps"])
    return n


def step_bytes_floor(config: dict) -> int:
    """Bytes one outer step must move at the least, in f32: every point
    coordinate read once, every meta-parameter and both Adam moments read
    and written once."""
    hp = {**config["settings"], **config["flags"]}
    model = config["flop_model"]
    d = config["in_dim"]
    sets = 1 + int(hp["maml.inner_steps"])
    pts = sets * sum(k["points"] for k in model["kinds"] + model.get(
        "outer_kinds", model["kinds"]))
    return 4 * (int(hp["maml.bsize"]) * pts * d + 2 * 3 * meta_parameters(config))
