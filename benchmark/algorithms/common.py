"""What the meta-learners' adapters share: the program's config from the
configuration file, and its parameter tree as named leaves."""

from metapde_tpu_torch.config import Config, parse_overrides


def program_config(config: dict) -> Config:
    """The program's Config: its defaults, then the configuration's
    settings and the script's flags, each `--key=value`."""
    items = {**config["settings"], **config["flags"]}
    return parse_overrides(Config(), [f"--{k}={v}" for k, v in items.items()])


def flat(tree: dict, prefix: str = "") -> dict:
    """{"layers": [{"w", "b"}, ...], "log_in_scale", "log_out_scale"} ->
    {"layers.0.w": ..., ..., "log_in_scale": ..., "log_out_scale": ...}."""
    out = {f"{prefix}layers.{i}.{k}": layer[k] for i, layer in enumerate(tree["layers"])
           for k in ("w", "b")}
    out.update({prefix + k: v for k, v in tree.items() if k != "layers"})
    return out


def nested(leaves: dict) -> dict:
    """flat's inverse (leaves without a prefix)."""
    n = sum(1 for k in leaves if k.endswith(".w"))
    tree = {"layers": [{"w": leaves[f"layers.{i}.w"], "b": leaves[f"layers.{i}.b"]}
                       for i in range(n)]}
    tree.update({k: v for k, v in leaves.items() if not k.startswith("layers.")})
    return tree


def adam_b1(cfg_optimizer: str) -> float:
    """b1 of the program's outer optimizer, to read its first gradient
    back from its first moment; only Adam is read."""
    if cfg_optimizer != "adam":
        raise ValueError(f"the first gradient is read from Adam's state, not {cfg_optimizer!r}")
    return 0.9
