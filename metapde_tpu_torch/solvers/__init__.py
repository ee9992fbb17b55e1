"""Ground-truth solvers in PyTorch (counterpart of metapde_tpu/solvers).

fem_poisson (P1 FEM, matrix-free Newton-BiCGStab with the Jacobi or the
multigrid preconditioner, the float64 and Richardson oracles), multigrid
(the polar and the rect-lattice V-cycles), newton, fv_burgers and
fem_td_burgers, mesh2d (the pore-snapped lattice), fem_elasticity (the
sparse-direct neo-Hookean solve), fem_steady_burgers (steady Burgers past
pores) and interpolation (Taylor and k-NN interpolants).
"""

from . import fem_elasticity  # noqa: F401
from . import fem_poisson  # noqa: F401
from . import fem_steady_burgers  # noqa: F401
from . import fem_td_burgers  # noqa: F401
from . import fv_burgers  # noqa: F401
from . import interpolation  # noqa: F401
