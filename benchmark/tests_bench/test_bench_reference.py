"""The plain reference: its Taylor-mode pass against autograd, its losses
against the definitions, and the port's checked steps against it."""

import math

import pytest
import torch

from benchmark import harness
from benchmark.reference import laws, optim, siren
from benchmark.reference.pdes import poisson3d
from conftest import WORKLOADS, tiny_cell


def _params(t, d, width=8, layers=3, seed=0):
    gen = torch.Generator().manual_seed(seed)
    p = siren.init(gen, d, width, layers, 30.0, 30.0, 10.0, "cpu")
    p = {k: v.double()[None].expand((t,) + tuple(v.shape)).clone() for k, v in p.items()}
    for k in p:  # biases and scales away from their init, so every term shows
        p[k] += 0.01 * torch.randn(p[k].shape, generator=gen, dtype=torch.float64)
    return p


@pytest.mark.parametrize("d", [2, 3])
def test_vhd_is_autograd(d):
    p = _params(2, d)
    x = torch.rand(2, 17, d, dtype=torch.float64, generator=torch.Generator().manual_seed(1))
    for a, b in zip(siren.vhd(p, x, 30.0), siren.vhd_autograd(p, x, 30.0)):
        torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-9)


def test_init_bounds():
    p = siren.init(torch.Generator().manual_seed(0), 3, 128, 5, 30.0, 30.0, 10.0, "cpu")
    assert p["layers.0.w"].abs().max() <= 1.0 / 3
    assert p["layers.1.w"].abs().max() <= math.sqrt(6 / 128) / 30
    assert p["layers.5.w"].shape == (128, 1)
    assert torch.all(p["log_in_scale"] == math.log(0.1))


def test_poisson3d_source_is_the_operator_of_the_solution():
    """f = div((1 + 0.1 u^2) grad u) of u*, by central differences."""
    gen = torch.Generator().manual_seed(2)
    tp = (torch.randn(1, 2, 4, generator=gen, dtype=torch.float64),
          torch.rand(1, 4, generator=gen, dtype=torch.float64))
    x = 0.5 * torch.randn(1, 5, 3, generator=gen, dtype=torch.float64)
    h, div = 1e-4, 0.0
    for i in range(3):
        e = torch.zeros(3, dtype=torch.float64)
        e[i] = h / 2

        def flux(y):
            u = poisson3d.exact(tp, y)
            du = (poisson3d.exact(tp, y + e) - poisson3d.exact(tp, y - e)) / h
            return (1 + 0.1 * u ** 2) * du
        div = div + (flux(x + e) - flux(x - e)) / h
    torch.testing.assert_close(poisson3d.source(tp, x), div, rtol=1e-5, atol=1e-5)


def _by_autograd(p, pts, tp, hp):
    """The family's loss written out from its definition, derivatives by autograd."""
    xb, xd = pts
    u, g, hd = siren.vhd_autograd(p, xd, 30.0)
    lhs = (1 + 0.1 * u ** 2) * hd.sum(-1) + 0.2 * u * (g ** 2).sum(-1)
    return (hp["task.bc_weight"] * ((poisson3d.exact(tp, xb) - siren.forward(p, xb, 30.0))
                                    ** 2).mean(1)
            + ((lhs - poisson3d.source(tp, xd)) ** 2).mean(1))


def test_task_loss_is_its_definition():
    gen = torch.Generator().manual_seed(4)
    hp = {"model.omega": 30.0, "task.bc_weight": 3.0}

    def r(*shape):
        return torch.rand(*shape, generator=gen, dtype=torch.float64)
    p = _params(2, 3)
    pts = (r(2, 7, 3) - 0.5, r(2, 9, 3) - 0.5)
    tp = (torch.randn(2, 2, 4, generator=gen, dtype=torch.float64), r(2, 4), r(2, 2) * 0.2)
    torch.testing.assert_close(poisson3d.task_loss(p, pts, tp, hp), _by_autograd(p, pts, tp, hp),
                               rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_port_follows_the_reference(workload):
    """Three checked steps of the port at a tiny size on the CPU against the
    reference: every number far inside the cell's limits."""
    cell = tiny_cell(workload)
    torch.set_num_threads(2)
    run = harness.checked_steps(cell, 2 ** 31 + 7, torch.device("cpu"))
    out = harness.reference_check(cell, run, torch.device("cpu"))
    assert out["draw_violations"] == 0, out["_violations"]
    for k in ("loss_gap", "grad_gap", "change_gap"):
        assert out[k] < 1e-5, (k, out[k])


def test_hyper_types():
    hp = optim.hyper({"settings": {"a": "true", "b": "1e-4"}, "flags": {"c": "32", "a": "false"}})
    assert hp == {"a": False, "b": 1e-4, "c": 32}


def _star_draws(gen, t, sets, n, fault=None):
    """poisson3d draws by its definition, written out here (rejection in
    the bounding ball), or with one `fault` planted: (task params, points)."""
    def r(*shape):
        return torch.rand(*shape, generator=gen, dtype=torch.float64)

    def dirs(*shape):
        d = (2 * r(*shape, 3) - 1 if fault == "cube_directions"
             else torch.randn(*shape, 3, generator=gen, dtype=torch.float64))
        return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    bumps = torch.randn(t, 2, 4, generator=gen, dtype=torch.float64)
    bumps[..., :3] *= 1.0 if fault == "wide_centres" else 0.5
    tp = (bumps, 2 * r(t, 4) - 1, 0.4 * r(t, 2) - 0.2)
    nb = dirs(t, sets * n)
    xb = poisson3d.radius(nb, tp[2])[..., None] * nb
    cand = dirs(t, 24 * sets * n) * 1.45 * (
        r(t, 24 * sets * n, 1) if fault == "linear_radius" else r(t, 24 * sets * n, 1) ** (1 / 3))
    length = torch.linalg.vector_norm(cand, dim=-1)
    inside = length < poisson3d.radius(cand / length[..., None], tp[2])
    xd = torch.stack([cand[i][inside[i]][: sets * n] for i in range(t)])
    return tp, {"pts": (xb.reshape(t, sets, n, 3), xd.reshape(t, sets, n, 3))}


@pytest.mark.parametrize("fault", [None, "cube_directions", "wide_centres", "linear_radius"])
def test_draw_laws_see_a_wrong_distribution(fault):
    """Sound draws pass the laws over three steps; each planted fault,
    inside the support, fails its own."""
    gen = torch.Generator().manual_seed(2 ** 32 + 3)
    samples = {}
    for _ in range(3):
        tp, points = _star_draws(gen, 32, 2, 256, fault)
        for k, v in poisson3d.draw_laws(tp, points, {"task.bc_scale": 1.0}).items():
            samples.setdefault(k, []).append(v)
    failed = set(laws.violations(samples))
    want = {None: set(), "cube_directions": {f"law:pts.boundary_n{a}" for a in "xyz"},
            "wide_centres": {"law:bump_centres"},
            "linear_radius": {"law:pts.domain_radius_cubed"}}[fault]
    assert failed == want
