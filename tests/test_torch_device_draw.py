"""The MAML step's draw (train/maml_driver.py): on a CPU build every draw
from the caller's host generator, bit for bit as before; on a card build
the task params from it and the point sets on the card, from a device
generator that one draw of it seeds (draw_seeded), replayed on the host by
draw_all; the validation draw on the host on either device.

The tests marked `card` need a CUDA card and skip here. On a card, from
the root of a checkout:

    python -m pytest tests/test_torch_device_draw.py -m card -p no:cacheprovider --noconftest

(--noconftest: tests/conftest.py sets up JAX, which these tests do not use.)
"""

import pytest
import torch

from metapde_tpu_torch.config import Config, parse_overrides
from metapde_tpu_torch.meta import maml
from metapde_tpu_torch.pdes.registry import constant, multinomial
from metapde_tpu_torch.train import maml_driver
from metapde_tpu_torch.utils import spans
from metapde_tpu_torch.utils.trees import tree_leaves, tree_stack

K = 2
SMALL = ["--model.num_layers=2", "--model.layer_size=16", "--maml.bsize=3",
         f"--maml.inner_steps={K}", "--train.remat_inner_steps=false"]
# each MAML family at a test size: (flags, points a set)
FAMILIES = {
    "poisson": (["--task.pde=poisson"], 64),
    "poisson3d": (["--task.pde=poisson3d"], 64),
    "td_burgers": (["--task.pde=td_burgers"], 128),
    "hyper_elasticity": (["--task.pde=hyper_elasticity", "--task.max_holes=3",
                          "--task.max_hole_size=0.5", "--task.domain.xmin=0",
                          "--task.domain.ymin=0"], 64),
    "steady_burgers": (["--task.pde=steady_burgers"], 64),
}
SEED = 2 ** 33 + 21  # a host seed past 32 bits
# the benchmark cell p3d_maml_train's draw: poisson3d at 5x128, bsize 32,
# 5 inner steps, 2048 inner and outer points, without replacement
CELL_FLAGS = ["--task.pde=poisson3d", "--model.num_layers=5", "--model.layer_size=128",
              "--model.omega=30", "--model.omega0=30", "--maml.inner_steps=5",
              "--maml.bsize=32", "--task.inner_points=2048", "--task.outer_points=2048",
              "--task.bc_weight=1.0", "--task.bc_scale=1.0",
              "--task.sample_with_replacement=false", "--train.remat_inner_steps=true"]


def _cfg(family, *extra):
    flags, n = FAMILIES[family]
    return parse_overrides(Config(), flags + SMALL + [
        f"--task.inner_points={n}", f"--task.outer_points={n}", *extra])


def _gen(seed=SEED):
    return torch.Generator().manual_seed(seed)


def _equal(a, b):
    la, lb = tree_leaves(tuple(a)), tree_leaves(tuple(b))
    return len(la) == len(lb) and all(
        x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _composition(cfg, pde, gen):
    """The parent's draw: bsize task params, then the inner and the outer
    point sets, all from `gen`."""
    tp = tree_stack([pde.sample_params(gen) for _ in range(cfg.maml.bsize)])
    sets = cfg.maml.inner_steps + 1
    return maml.TaskBatch(
        task_params=tp,
        inner_points=pde.sample_points_batched(gen, cfg.task.inner_points, tp, sets),
        outer_points=pde.sample_points_batched(gen, cfg.task.outer_points, tp, sets))


# --- CPU builds ---------------------------------------------------------------

@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_a_cpu_build_draws_as_before(family):
    """draw_all and draw_step_inputs on a CPU build: the host composition
    on the same generator, bit for bit, leaving it in the same state."""
    cfg = _cfg(family)
    c = maml_driver.build(cfg, "cpu")
    want_gen = _gen()
    want = _composition(cfg, c["pde"], want_gen)
    for name in ("draw_all", "draw_step_inputs"):
        gen = _gen()
        assert _equal(c[name](gen), want), name
        assert torch.equal(gen.get_state(), want_gen.get_state()), name


@pytest.mark.parametrize("family", ["poisson3d", "steady_burgers"])
def test_the_seeded_draw_splits_the_generators(family):
    """draw_seeded, the card build's draw, with a CPU point generator: the
    task params those of the host draw from the same state; then one
    63-bit draw of the host generator seeds the point generator, which
    alone draws the point sets."""
    cfg = _cfg(family)
    c = maml_driver.build(cfg, "cpu")
    gen, points_gen = _gen(), torch.Generator().manual_seed(7)
    got = c["draw_seeded"](gen, points_gen)
    host = c["draw_host"](_gen())
    assert _equal(got.task_params, host.task_params)
    want_gen = _gen()
    tp = tree_stack([c["pde"].sample_params(want_gen) for _ in range(cfg.maml.bsize)])
    seed = int(torch.randint(2 ** 63 - 1, (), generator=want_gen))
    assert torch.equal(gen.get_state(), want_gen.get_state())
    points_want = torch.Generator().manual_seed(seed)
    for name, n in (("inner_points", cfg.task.inner_points),
                    ("outer_points", cfg.task.outer_points)):
        want = c["pde"].sample_points_batched(points_want, n, tp, cfg.maml.inner_steps + 1)
        assert _equal(getattr(got, name), want), name
    assert not _equal(got.inner_points, host.inner_points)
    # the point generator is re-seeded at every draw
    assert _equal(c["draw_seeded"](_gen(), points_gen), got)


def test_validation_draws_on_the_host():
    """validation_losses: the losses on draw_host's batch from a generator
    seeded 0, its every byte sent to the device."""
    cfg = _cfg("poisson3d")
    c = maml_driver.build(cfg, "cpu")
    batch = c["draw_host"](torch.Generator().manual_seed(0))
    _, want_losses, want_meta = maml.multi_task_grad_and_losses(
        c["maml_def"], c["task_loss"], batch, c["init_params"], c["inner_lrs"], need_grad=False)
    with spans.recording() as rec:
        losses, meta = c["validation_losses"](c["init_params"], c["inner_lrs"])
    assert torch.equal(losses, want_losses) and torch.equal(meta[0], want_meta[0])
    assert rec.counters["h2d_bytes"] == sum(t.nbytes for t in tree_leaves(tuple(batch)))
    assert "draw.on_device" not in rec.counters


@pytest.mark.parametrize("values", [0.1, -1.45, [0.0, 1.0], [-1.5, 2.0 / 3.0], 1e-30])
def test_constant_has_torch_tensor_s_bits(values):
    got = constant(values, torch.device("cpu"))
    want = torch.tensor(values, dtype=torch.float32)
    assert got.dtype == want.dtype and got.shape == want.shape and torch.equal(got, want)


@pytest.mark.parametrize("replacement", [True, False])
@pytest.mark.parametrize("n", [1, 5, 64])
@pytest.mark.parametrize("shape", [(4, 3 * 40), (3 * 40,)], ids=["rows", "one"])
def test_multinomial_is_torch_s_on_the_cpu(replacement, n, shape):
    """Bit for bit torch.multinomial's, on 1e-30 and 0 weights among ones as
    the families weight their candidates, rows or one distribution."""
    w = torch.rand(shape, generator=_gen(3)) * (torch.arange(shape[-1]) % 3 > 0) + 1e-30 * (
        torch.arange(shape[-1]) % 5 == 0)
    got = multinomial(w, n, replacement, _gen(4))
    want = torch.multinomial(w, n, replacement=replacement, generator=_gen(4))
    assert got.dtype == want.dtype and torch.equal(got, want)


# --- card builds --------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda", 0)


def _cell_config():
    return parse_overrides(Config(), CELL_FLAGS)


@pytest.mark.card
def test_the_cell_s_draw_replays_bit_for_bit(card):
    """poisson3d at the benchmark cell's flags (bsize 32, 2048 points):
    draw_step_inputs' batch all on the card, only the task params sent,
    one draw.on_device; draw_all from the same host state gives it on the
    host bit for bit and leaves the generator in the same state."""
    c = maml_driver.build(_cell_config(), card)
    gen = _gen()
    c["draw_step_inputs"](gen)  # warm-up
    start = gen.get_state()
    with spans.recording() as rec:
        batch = c["draw_step_inputs"](gen)
    leaves = tree_leaves(tuple(batch))
    assert all(t.device == card for t in leaves)
    tp_bytes = sum(t.nbytes for t in batch.task_params)
    assert tp_bytes == 1792
    assert rec.counters["h2d_bytes"] == tp_bytes and rec.counters["draw.on_device"] == 1
    replay = torch.Generator()
    replay.set_state(start)
    host = c["draw_all"](replay)
    assert all(t.device.type == "cpu" for t in tree_leaves(tuple(host)))
    got = tree_leaves(tuple(host))
    assert len(got) == len(leaves)
    assert all(a.dtype == b.dtype and torch.equal(a, b.cpu()) for a, b in zip(got, leaves))
    assert torch.equal(replay.get_state(), gen.get_state())


def _reads_nothing_back(c, card):
    """draw_step_inputs after one warm-up draw, under
    torch.cuda.set_sync_debug_mode("error"): its batch, all on the card."""
    gen = _gen()
    c["draw_step_inputs"](gen)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        batch = c["draw_step_inputs"](gen)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert all(t.device == card for t in tree_leaves(tuple(batch)))


@pytest.mark.card
def test_the_cell_s_draw_reads_nothing_back(card):
    _reads_nothing_back(maml_driver.build(_cell_config(), card), card)


@pytest.mark.card
@pytest.mark.parametrize("family", ["poisson", "td_burgers", "hyper_elasticity",
                                    "steady_burgers"])
def test_other_families_draws_read_nothing_back(card, family):
    _reads_nothing_back(maml_driver.build(_cfg(family), card), card)


@pytest.mark.card
def test_the_cell_s_card_draws_keep_the_family_s_laws(card):
    """Three outer steps' draws (the harness's checked steps) pass the
    benchmark reference's check of the draws and its laws."""
    from benchmark.reference import laws
    from benchmark.reference.pdes import poisson3d as ref
    cfg = _cell_config()
    hp = {"task.bc_scale": cfg.task.bc_scale}
    c = maml_driver.build(cfg, card)
    gen, samples, bad = _gen(), {}, {}
    sets = {"inner_points": (cfg.task.inner_points, cfg.maml.inner_steps + 1),
            "outer_points": (cfg.task.outer_points, cfg.maml.inner_steps + 1)}
    for _ in range(3):
        b = c["draw_all"](gen)
        points = {"inner_points": tuple(b.inner_points), "outer_points": tuple(b.outer_points)}
        for k, v in ref.check_draw(tuple(b.task_params), points, cfg.maml.bsize, sets,
                                   hp).items():
            bad[k] = bad.get(k, 0) + v
        for k, v in ref.draw_laws(tuple(b.task_params), points, hp).items():
            samples.setdefault(k, []).append(v)
    assert sum(bad.values()) == 0, bad
    assert laws.violations(samples) == {}


@pytest.mark.card
@pytest.mark.parametrize("family", ["poisson", "td_burgers", "hyper_elasticity",
                                    "steady_burgers"])
def test_other_families_draw_on_the_card(card, family):
    """The card's draw_all has the CPU draw's shapes and dtypes, and
    replays draw_step_inputs bit for bit."""
    cfg = _cfg(family)
    cpu, c = maml_driver.build(cfg, "cpu"), maml_driver.build(cfg, card)
    want = cpu["draw_all"](_gen())
    gen = _gen()
    batch = c["draw_step_inputs"](gen)
    leaves = tree_leaves(tuple(batch))
    assert all(t.device == card for t in leaves)
    replay = _gen()
    host = c["draw_all"](replay)
    assert [(t.shape, t.dtype) for t in tree_leaves(tuple(host))] == \
        [(t.shape, t.dtype) for t in tree_leaves(tuple(want))]
    assert all(torch.equal(a, b.cpu()) for a, b in zip(tree_leaves(tuple(host)), leaves))
    assert torch.equal(replay.get_state(), gen.get_state())


@pytest.mark.card
def test_validation_draws_on_the_host_on_a_card(card):
    cfg = _cfg("poisson3d")
    c = maml_driver.build(cfg, card)
    batch = c["draw_host"](torch.Generator().manual_seed(0))
    with spans.recording() as rec:
        c["validation_losses"](c["init_params"], c["inner_lrs"])
    assert rec.counters["h2d_bytes"] == sum(t.nbytes for t in tree_leaves(tuple(batch)))
    assert "draw.on_device" not in rec.counters


@pytest.mark.card
@pytest.mark.parametrize("replacement,n", [(False, 1), (False, 2048), (True, 1)])
def test_multinomial_is_torch_s_on_a_card(card, replacement, n):
    """Bit for bit torch.multinomial's on a card generator, on the
    families' weights: ones and 1e-30 (poisson3d's) and zeros; after a
    warm-up, with no host read."""
    i = torch.arange(4 * 2048, device=card)
    w = ((i % 4 > 0).float() + 1e-30 * (i % 7 == 0)).repeat(8, 1)
    gen = torch.Generator(device=card)
    multinomial(w, n, replacement, gen)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = multinomial(w, n, replacement, gen.manual_seed(SEED))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want = torch.multinomial(w, n, replacement=replacement,
                             generator=torch.Generator(device=card).manual_seed(SEED))
    assert got.dtype == want.dtype and torch.equal(got, want)
