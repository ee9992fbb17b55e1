"""Run directories, tee-logging and the metrics stream (counterpart of
metapde_tpu/train/metrics.py).

prepare_logging makes the experiment dir (an existing one is never
deleted: a numeric suffix is added instead), log.txt and metrics.jsonl, one
JSON record per validation with the JAX package's keys, and mirrors every
numeric scalar of a record (ints, floats and bools that are not NaN, by
the JAX package's rule) to TensorBoard events under <run>/tb/
(utils/tensorboard_logger.Logger); a logger that cannot be built leaves
the jsonl stream alone.
"""

import json
import os
import time
from typing import Optional


def prepare_logging(out_dir: Optional[str], expt_name: Optional[str]):
    """Create the experiment dir and return (path, log_fn, metrics_logger);
    (None, print, None) when either name is None."""
    if expt_name is None or out_dir is None:
        def log(*args, **kwargs):
            print(*args, **kwargs, flush=True)

        return None, log, None

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, expt_name)
    if os.path.exists(path):
        suffix = 1
        while os.path.exists(f"{path}_{suffix}"):
            suffix += 1
        path = f"{path}_{suffix}"
    os.makedirs(path)

    outfile = open(os.path.join(path, "log.txt"), "w")

    def log(*args, **kwargs):
        print(*args, **kwargs, flush=True)
        print(*args, **kwargs, file=outfile, flush=True)

    return path, log, MetricsLogger(os.path.join(path, "metrics.jsonl"),
                                    tb_dir=os.path.join(path, "tb"))


class MetricsLogger:
    """Append-only jsonl metrics writer, its scalars mirrored to
    TensorBoard events under tb_dir (None: no mirror)."""

    def __init__(self, path: str, tb_dir: Optional[str] = None):
        self._f = open(path, "a")
        self._tb = None
        if tb_dir is not None:
            from ..utils.tensorboard_logger import Logger

            try:
                self._tb = Logger(tb_dir)
            except OSError as e:
                print(f"no TensorBoard mirror ({e}); metrics.jsonl only", flush=True)

    def log(self, step: int, **metrics):
        rec = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            rec[k] = _to_py(v)
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._tb is not None:
            for k, v in rec.items():
                if k not in ("step", "time") and isinstance(v, (int, float)) and v == v:
                    self._tb.log_scalar(k, float(v), int(step))

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()


def _to_py(v):
    """Tensors and arrays -> floats or (nested) lists; None stays None."""
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    if hasattr(v, "shape") and v.shape not in ((), None):
        return v.tolist()
    if hasattr(v, "item"):
        return v.item()
    if isinstance(v, (list, tuple)):
        return [_to_py(x) for x in v]
    return v
