"""Matrix-free Newton-Krylov (counterpart of metapde_tpu/solvers/newton.py).

J v comes from torch.func.jvp of the residual; the Jacobian is never built.
BiCGStab is written out by hand with the semantics of
jax.scipy.sparse.linalg.bicgstab. Both loops run eagerly and read one scalar
back to the host per iteration for their stopping test, and no more.
``bicgstab.iterations`` and ``newton_krylov.steps`` count the iterations
each has run, as plain integers a caller may reset and read.
"""

from typing import Callable, NamedTuple

import torch


class NewtonResult(NamedTuple):
    u: torch.Tensor
    residual_norm: torch.Tensor
    iterations: int


def bicgstab(A: Callable, b: torch.Tensor, *, tol: float = 1e-5,
             atol: float = 0.0, maxiter: int, M: Callable = None) -> torch.Tensor:
    """Solve A x = b from x0 = 0 by preconditioned BiCGStab.

    As jax.scipy.sparse.linalg.bicgstab: stops when |r|^2 <= max(tol^2 |b|^2,
    atol^2), after `maxiter` iterations (without error), or on breakdown
    (rho, alpha or omega exactly 0); M is a left preconditioner applied as
    M(v). A is linear, so r0 = b - A(0) = b.
    """
    M = M if M is not None else (lambda v: v)
    atol2 = torch.clamp(tol ** 2 * torch.dot(b, b), min=atol ** 2)
    x = torch.zeros_like(b)
    r = b.clone()
    rhat = r
    one = torch.ones((), dtype=b.dtype, device=b.device)
    alpha, omega, rho = one, one, one
    p, q = r, r
    broken = torch.zeros((), dtype=torch.bool, device=b.device)
    for _ in range(maxiter):
        if not bool(((torch.dot(r, r) > atol2) & ~broken).item()):
            break
        bicgstab.iterations += 1
        rho_ = torch.dot(rhat, r)
        beta = rho_ / rho * alpha / omega
        p = r + beta * (p - omega * q)
        phat = M(p)
        q = A(phat)
        alpha = rho_ / torch.dot(rhat, q)
        s = r - alpha * q
        exit_early = torch.dot(s, s) < atol2
        shat = M(s)
        t = A(shat)
        omega = torch.dot(t, s) / torch.dot(t, t)
        x = torch.where(exit_early, x + alpha * phat, x + alpha * phat + omega * shat)
        r = torch.where(exit_early, s, s - omega * t)
        broken = (omega == 0) | (alpha == 0) | (rho_ == 0)
        rho = rho_
    return x


bicgstab.iterations = 0


def newton_krylov(
    residual_fn: Callable,
    u0: torch.Tensor,
    max_steps: int = 30,
    rel_tol: float = 2e-5,
    abs_tol: float = 1e-12,
    damping: float = 1.0,
    krylov_tol: float = 1e-5,
    krylov_max_iters: int = 400,
    precond_diag: torch.Tensor = None,
    precond_apply: Callable = None,
) -> NewtonResult:
    """Solve residual_fn(u) = 0 by damped Newton with matrix-free BiCGStab.

    Tolerances are relative to the initial residual norm. Each step tries
    the step fractions (1, 0.5, 0.25, 0.1) * damping and keeps the one with
    the smallest residual; a step that does not lower the residual ends the
    iteration. The Krylov solve is preconditioned by `precond_apply` (e.g.
    a multigrid V-cycle, multigrid.py) when given, else by the Jacobi
    diagonal `precond_diag`. A Krylov solve that diverged (non-finite) is
    replaced by the preconditioned residual, a steepest-descent-like step.
    """
    minv = 1.0 / precond_diag if precond_diag is not None else None
    if precond_apply is not None:
        M = precond_apply
    elif minv is not None:
        M = lambda v: v * minv  # noqa: E731
    else:
        M = None

    def lin_solve(u, rhs):
        def jvp_fn(v):
            return torch.func.jvp(residual_fn, (u,), (v,))[1]

        sol = bicgstab(jvp_fn, rhs, tol=krylov_tol, maxiter=krylov_max_iters, M=M)
        bad = ~torch.isfinite(torch.sum(sol))
        fallback = M(rhs) if M is not None else rhs
        return torch.where(bad, fallback, sol)

    rnorm = torch.linalg.norm(residual_fn(u0))
    target = torch.clamp(rel_tol * rnorm, min=abs_tol)
    alphas = torch.tensor([1.0, 0.5, 0.25, 0.1], dtype=u0.dtype, device=u0.device) * damping

    u = u0
    improved = torch.ones((), dtype=torch.bool, device=u0.device)
    it = 0
    while it < max_steps:
        # one host read: not yet converged, and the last step improved
        go, progressed = torch.stack([rnorm > target, improved]).tolist()
        if not (go and progressed):
            break
        r = residual_fn(u)
        du = lin_solve(u, -r)
        rnorms = torch.stack([torch.linalg.norm(residual_fn(u + a * du)) for a in alphas])
        rnorms = torch.where(torch.isfinite(rnorms), rnorms, torch.full_like(rnorms, torch.inf))
        best = torch.argmin(rnorms)
        improved = rnorms[best] < rnorm
        u = torch.where(improved, u + alphas[best] * du, u)
        rnorm = torch.where(improved, rnorms[best], rnorm)
        it += 1
        newton_krylov.steps += 1
    # JAX's loop jumps its counter to max_steps when a step does not improve
    iterations = it if bool(improved.item()) else max_steps
    return NewtonResult(u=u, residual_norm=rnorm, iterations=iterations)


newton_krylov.steps = 0
