"""The port's recorder (utils/spans.py): off by default, and with it on the
spans of a MAML step in order and nested, the bytes sent to the device,
and the step's outputs unchanged."""

import threading

import pytest
import torch

from metapde_tpu_torch.config import Config, parse_overrides
from metapde_tpu_torch.train import maml_driver
from metapde_tpu_torch.utils import spans
from metapde_tpu_torch.utils.trees import tree_leaves

K = 2
TINY = ["--task.pde=poisson3d", "--task.inner_points=64", "--task.outer_points=64",
        "--model.num_layers=2", "--model.layer_size=16", "--maml.bsize=2",
        f"--maml.inner_steps={K}"]


def _build(remat=True):
    cfg = parse_overrides(Config(), TINY + [f"--train.remat_inner_steps={str(remat).lower()}"])
    c = maml_driver.build(cfg, "cpu")
    state = (c["init_params"], c["inner_lrs"], c["outer_opt"].init(c["init_params"]),
             c["lr_opt"].init(c["inner_lrs"]))
    return c, state


def test_off_records_nothing_and_shares_one_no_op():
    assert spans.span("a") is spans.span("b", new_step=True)
    with spans.span("a"):
        spans.count("test.off", 3)
    with spans.recording() as rec:
        pass
    assert rec.spans == [] and rec.counters == {}
    assert spans.counter("test.off") == 3  # counters count with the recorder off


def test_recordings_nest_and_spans_keep_their_parents():
    with spans.recording() as outer:
        with spans.span("a", new_step=True):
            with spans.recording() as inner:
                with spans.span("b"):
                    spans.count("test.nest", 2)
        assert spans.span("c") is not spans.span("c")  # still on
    assert spans.span("c") is spans.span("d")  # off once the outermost ends
    a, b = outer.spans
    assert [s.name for s in inner.spans] == ["b"] and inner.counters == {"test.nest": 2}
    assert (a.name, a.parent, b.parent, a.step, b.step) == ("a", None, a.id, 1, 1)
    assert a.start_ns <= b.start_ns <= b.end_ns <= a.end_ns
    assert a.thread == b.thread == threading.get_ident()


@pytest.mark.parametrize("remat", [True, False])
def test_a_maml_step_s_spans_in_order_and_nested(remat):
    c, state = _build(remat)
    with spans.recording() as rec:
        c["train_step"](torch.Generator().manual_seed(3), *state)
    got = rec.spans
    names = [s.name for s in got]
    sample = ["draw.candidates", "draw.choice"] * 2  # the inner and the outer point sets
    assert names == (["draw", "draw.sample"] + sample + ["draw.to_device", "step"]
                     + ["maml.inner_step"] * K + ["maml.meta_backward", "outer_update"])
    by = {s.id: s for s in got}
    parent = [None if s.parent is None else by[s.parent].name for s in got]
    assert parent == ([None, "draw"] + ["draw.sample"] * 4 + ["draw", None]
                      + ["step"] * (K + 2))
    assert {s.step for s in got} == {1}
    for s in got:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            p = by[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    # the step follows the draw
    draw, step = (next(s for s in got if s.name == n) for n in ("draw", "step"))
    assert draw.end_ns <= step.start_ns


def test_h2d_bytes_are_the_batch_s_bytes():
    c, _ = _build()
    with spans.recording() as rec:
        batch = c["draw_step_inputs"](torch.Generator().manual_seed(5))
    assert rec.counters["h2d_bytes"] == sum(t.nbytes for t in tree_leaves(tuple(batch)))


def test_the_step_is_bit_identical_with_the_recorder_on():
    c, state = _build()
    off = c["train_step"](torch.Generator().manual_seed(7), *state)
    with spans.recording(), spans.span("outside", new_step=True):
        on = c["train_step"](torch.Generator().manual_seed(7), *state)
    a, b = tree_leaves(off), tree_leaves(on)
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
