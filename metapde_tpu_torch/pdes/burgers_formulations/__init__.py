"""Burgers formulation registry (counterpart of
metapde_tpu/pdes/burgers_formulations/__init__.py).

Each formulation provides the initial condition ``ic_fn`` (which the FV and
FEM ground-truth solvers also use) and the initial and wall losses.
"""

from . import default

FORMULATIONS = {
    "default": default,
}


def get_formulation(name: str):
    try:
        return FORMULATIONS[name]
    except KeyError:
        raise ValueError(
            f"unknown burgers formulation {name!r}; have {sorted(FORMULATIONS)}")
