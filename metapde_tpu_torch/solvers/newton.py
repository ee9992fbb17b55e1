"""Matrix-free Newton-Krylov (counterpart of metapde_tpu/solvers/newton.py).

J v comes from forward-mode autodiff of the residual (torch.autograd.forward_ad
dual tensors; torch.func.jvp gives the same values but runs the residual's
ops through Python decompositions, several ms a call); the Jacobian is
never built.
BiCGStab is written out by hand with the semantics of
jax.scipy.sparse.linalg.bicgstab. Both loops read one scalar back to the
host per iteration for their stopping test, and no more. On a CUDA device
and when the caller asks (cuda_graph=True: its residual and preconditioner
make no host reads), one BiCGStab iteration is captured as a CUDA graph and
replayed in place of the hundreds of eager launches it makes: the same
kernels on the same values, so the same iterates.
``cg`` is jax.scipy.sparse.linalg.cg's conjugate gradients, for the
elasticity cascade's Hessian-vector products, with the same single host
read an iteration and the same graph option.
``bicgstab.iterations``, ``cg.iterations`` and ``newton_krylov.steps``
count the iterations each has run, as plain integers a caller may reset and read.
"""

from typing import Callable, NamedTuple

import torch
import torch.autograd.forward_ad as fwad


class NewtonResult(NamedTuple):
    u: torch.Tensor
    residual_norm: torch.Tensor
    iterations: int


def bicgstab(A: Callable, b: torch.Tensor, *, tol: float = 1e-5,
             atol: float = 0.0, maxiter: int, M: Callable = None,
             cuda_graph: bool = False) -> torch.Tensor:
    """Solve A x = b from x0 = 0 by preconditioned BiCGStab.

    As jax.scipy.sparse.linalg.bicgstab: stops when |r|^2 <= max(tol^2 |b|^2,
    atol^2), after `maxiter` iterations (without error), or on breakdown
    (rho, alpha or omega exactly 0); M is a left preconditioner applied as
    M(v). A is linear, so r0 = b - A(0) = b. cuda_graph=True replays each
    iteration as one CUDA graph when b lies on a CUDA device (A and M must
    then make no host reads).
    """
    M = M if M is not None else (lambda v: v)
    atol2 = torch.clamp(tol ** 2 * torch.dot(b, b), min=atol ** 2)
    # x, r, p, q, alpha, omega, rho, broken; rhat = r0 = b
    state = [torch.zeros_like(b), b.clone(), b.clone(), b.clone(),
             *(torch.ones((), dtype=b.dtype, device=b.device) for _ in range(3)),
             torch.zeros((), dtype=torch.bool, device=b.device)]

    def step(x, r, p, q, alpha, omega, rho, broken):
        rho_ = torch.dot(b, r)
        beta = rho_ / rho * alpha / omega
        p = r + beta * (p - omega * q)
        phat = M(p)
        q = A(phat)
        alpha = rho_ / torch.dot(b, q)
        s = r - alpha * q
        exit_early = torch.dot(s, s) < atol2
        shat = M(s)
        t = A(shat)
        omega = torch.dot(t, s) / torch.dot(t, t)
        x = torch.where(exit_early, x + alpha * phat, x + alpha * phat + omega * shat)
        r = torch.where(exit_early, s, s - omega * t)
        broken = (omega == 0) | (alpha == 0) | (rho_ == 0)
        return [x, r, p, q, alpha, omega, rho_, broken]

    def go(state):
        return (torch.dot(state[1], state[1]) > atol2) & ~state[7]

    if cuda_graph and b.is_cuda:
        advance = _captured(step, go, state)
    else:
        def advance():
            state[:] = step(*state)
            return go(state)
    keep_going = go(state)
    for _ in range(maxiter):
        if not bool(keep_going.item()):
            break
        bicgstab.iterations += 1
        keep_going = advance()
    return state[0]


def cg(A: Callable, b: torch.Tensor, *, tol: float = 1e-5, atol: float = 0.0,
       maxiter: int, cuda_graph: bool = False) -> torch.Tensor:
    """Solve A x = b from x0 = 0 by conjugate gradients, A symmetric
    positive definite, with the semantics of jax.scipy.sparse.linalg.cg
    (no preconditioner): stops when |r|^2 <= max(tol^2 |b|^2, atol^2) or
    after `maxiter` iterations, without error. A is linear, so r0 = b. A
    non-finite curvature p.Ap makes gamma NaN, and the test then stops the
    loop, as JAX's while_loop stops. cuda_graph=True replays each iteration
    as one CUDA graph when b lies on a CUDA device (A must then make no
    host reads)."""
    atol2 = torch.clamp(tol ** 2 * torch.dot(b, b), min=atol ** 2)
    # x, r, p, gamma = r.r
    state = [torch.zeros_like(b), b.clone(), b.clone(), torch.dot(b, b)]

    def step(x, r, p, gamma):
        Ap = A(p)
        alpha = gamma / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        gamma_ = torch.dot(r, r)
        p = r + (gamma_ / gamma) * p
        return [x, r, p, gamma_]

    def go(state):
        return state[3] > atol2

    if cuda_graph and b.is_cuda:
        advance = _captured(step, go, state)
    else:
        def advance():
            state[:] = step(*state)
            return go(state)
    keep_going = go(state)
    for _ in range(maxiter):
        if not bool(keep_going.item()):
            break
        cg.iterations += 1
        keep_going = advance()
    return state[0]


cg.iterations = 0


def _captured(step, test, state):
    """One CUDA graph that writes step(*state) over `state`'s tensors and
    then evaluates test(state); returns replay() -> the test's result (a
    tensor each replay rewrites). The warm-up that CUDA graphs ask for runs
    on copies of the state."""
    dev = state[0].device
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        test(step(*[t.clone() for t in state]))
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for dst, src in zip(state, step(*state)):
            dst.copy_(src)
        flag = test(state)

    def replay():
        graph.replay()
        return flag

    return replay


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
    cuda_graph: bool = False,
) -> NewtonResult:
    """Solve residual_fn(u) = 0 by damped Newton with matrix-free BiCGStab.

    Tolerances are relative to the initial residual norm. Each step tries
    the step fractions (1, 0.5, 0.25, 0.1) * damping and keeps the one with
    the smallest residual; a step that does not lower the residual ends the
    iteration. The Krylov solve is preconditioned by `precond_apply` (e.g.
    a multigrid V-cycle, multigrid.py) when given, else by the Jacobi
    diagonal `precond_diag`. A Krylov solve that diverged (non-finite) is
    replaced by the preconditioned residual, a steepest-descent-like step.
    cuda_graph=True replays each BiCGStab iteration as a CUDA graph on a
    CUDA device (residual_fn and precond_apply must make no host reads).
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
            with fwad.dual_level():
                return fwad.unpack_dual(residual_fn(fwad.make_dual(u, v))).tangent

        sol = bicgstab(jvp_fn, rhs, tol=krylov_tol, maxiter=krylov_max_iters, M=M,
                       cuda_graph=cuda_graph)
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
