"""Ground-truth solvers in PyTorch (counterpart of metapde_tpu/solvers).

Ported so far: fem_poisson (P1 FEM, matrix-free Newton-BiCGStab with the
Jacobi preconditioner) and newton.
"""
