"""Ground-truth solvers in PyTorch (counterpart of metapde_tpu/solvers).

Ported so far: fem_poisson (P1 FEM, matrix-free Newton-BiCGStab with the
Jacobi or the multigrid preconditioner, the float64 and Richardson
oracles), multigrid (the polar V-cycle), newton, fv_burgers and
fem_td_burgers, mesh2d (the pore-snapped lattice) and fem_elasticity (the
sparse-direct neo-Hookean solve).
"""
