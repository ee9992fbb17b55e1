"""The port's TensorBoard writer (utils/tb_writer.py), Logger
(utils/tensorboard_logger.py) and the metrics mirror of train/metrics.py
against the JAX package's: byte-identical event files at a fixed wall
time on the native and the Python paths, and the same tb/ records for the
same metrics."""

import glob
import time

import numpy as np
import pytest

from metapde_tpu.train import metrics as j_metrics
from metapde_tpu.utils import tb_writer as j_tbw
from metapde_tpu_torch.train import metrics as t_metrics
from metapde_tpu_torch.utils import tb_writer as t_tbw
from metapde_tpu_torch.utils.tensorboard_logger import Logger

WALL = 1_700_000_000.25


def _write(module, logdir, prefer_native):
    w = module.EventWriter(str(logdir), prefer_native=prefer_native)
    w.scalar("val_loss", 0.5, 3)
    w.scalar("meta_loss", -1.25e-3, 1234567)
    w.histogram("weights", np.random.default_rng(0).standard_normal(100), 3)
    w.histogram("empty", [], 4)
    native = w._lib is not None
    w.close()
    (fname,) = glob.glob(str(logdir) + "/events*")
    return open(fname, "rb").read(), native


@pytest.mark.parametrize("native", [False, True], ids=["python", "native"])
def test_event_bytes_equal_the_jax_writers(tmp_path, monkeypatch, native):
    monkeypatch.setattr(time, "time", lambda: WALL)
    port, port_native = _write(t_tbw, tmp_path / "port", native)
    jax_bytes, jax_native = _write(j_tbw, tmp_path / "jax", False)
    assert port_native == native  # the host compiler builds the core here
    assert port == jax_bytes
    if native:
        # the JAX package's own native path, where its committed library loads
        jax_native_bytes, loaded = _write(j_tbw, tmp_path / "jax_native", True)
        if loaded:
            assert port == jax_native_bytes
    assert [r[1:] for r in t_tbw.read_scalars(next((tmp_path / "port").glob("events*")))] == [
        ("val_loss", 0.5), ("meta_loss", np.float32(-1.25e-3))]


def test_reader_checks_crcs(tmp_path):
    w = t_tbw.EventWriter(str(tmp_path), prefer_native=False)
    w.scalar("a", 1.0, 0)
    w.close()
    (fname,) = glob.glob(str(tmp_path) + "/events*")
    data = bytearray(open(fname, "rb").read())
    assert len(t_tbw.read_records(fname)) == 2
    data[-6] ^= 0x01
    open(fname, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        t_tbw.read_records(fname)


def _metrics(module, path):
    m = module.MetricsLogger(str(path / "metrics.jsonl"), tb_dir=str(path / "tb"))
    m.log(0, meta_loss=1.5, val_rel_err=0.1, vec=[1.0, 2.0], nan=float("nan"),
          note="x", missing=None, flag=True, count=3, inf=float("inf"))
    m.log(7, meta_loss=np.float32(1.25), val_rel_err=np.asarray(0.05), step_time=0.5)
    m.close()
    (fname,) = glob.glob(str(path / "tb" / "events*"))
    return t_tbw.read_scalars(fname)


def test_metrics_mirror_equals_the_jax_mirror(tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = _metrics(j_metrics, tmp_path / "jax")
    got = _metrics(t_metrics, tmp_path / "port")
    assert got == want
    assert [(s, t) for s, t, _ in got] == [
        (0, "meta_loss"), (0, "val_rel_err"), (0, "flag"), (0, "count"), (0, "inf"),
        (7, "meta_loss"), (7, "val_rel_err"), (7, "step_time")]


def test_prepare_logging_writes_the_tb_dir(tmp_path):
    path, log, metrics = t_metrics.prepare_logging(str(tmp_path), "run")
    metrics.log(2, val_rel_err=0.25)
    metrics.close()
    (fname,) = glob.glob(path + "/tb/events*")
    assert t_tbw.read_scalars(fname) == [(2, "val_rel_err", 0.25)]


def test_logger_plots_become_image_events(tmp_path):
    plt = pytest.importorskip("matplotlib.pyplot")
    logger = Logger(str(tmp_path))
    logger.log_scalar("loss", 2.0, 1)
    logger.log_histogram("w", np.arange(10.0), 1)
    fig, ax = plt.subplots()
    ax.plot([0, 1], [1, 0])
    logger.log_plots("fig", [fig], 1)
    plt.close(fig)
    logger.close()
    (images,) = glob.glob(str(tmp_path / "images" / "events*"))
    records = t_tbw.read_records(images)
    assert len(records) == 2 and b"fig/0" in records[1] and b"\x89PNG" in records[1]
