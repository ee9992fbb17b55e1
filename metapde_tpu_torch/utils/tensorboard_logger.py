"""TensorBoard Logger (counterpart of metapde_tpu/utils/tensorboard_logger.py):
log_scalar and log_histogram through utils/tb_writer.EventWriter (native
core or Python), log_plots as PNG image summaries of matplotlib figures in
an images/ event file of their own, written by the Python path.
"""

import io
import time

import numpy as np

from .tb_writer import EventWriter, _encode_event, _pb_bytes, _pb_int64


def _image_summary(tag: str, png: bytes, height: int, width: int) -> bytes:
    """Summary.Value{tag = 1, image = 4: {height 1, width 2, colorspace 3
    (4: RGBA), encoded_image_string 4}}."""
    img = _pb_int64(1, height) + _pb_int64(2, width) + _pb_int64(3, 4) + _pb_bytes(4, png)
    return _pb_bytes(1, _pb_bytes(1, tag.encode()) + _pb_bytes(4, img))


class Logger:
    """Scalar, histogram and figure logging to TensorBoard event files."""

    def __init__(self, log_dir: str):
        self.writer = EventWriter(log_dir)
        # images always go through the Python framing
        self._py = EventWriter(log_dir + "/images", prefer_native=False)

    def log_scalar(self, tag, value, step):
        self.writer.scalar(tag, float(value), int(step))

    def log_histogram(self, tag, values, step, bins=30):
        self.writer.histogram(tag, np.asarray(values), int(step), bins=bins)

    def log_plots(self, tag, figures, step):
        """One PNG image summary a figure, tagged {tag}/{i}; nothing without
        matplotlib."""
        try:
            import matplotlib.pyplot  # noqa: F401
        except ImportError:
            return
        for i, fig in enumerate(figures):
            buf = io.BytesIO()
            fig.canvas.draw()
            w, h = fig.canvas.get_width_height()
            fig.savefig(buf, format="png")
            summary = _image_summary(f"{tag}/{i}", buf.getvalue(), h, w)
            self._py._write_record(_encode_event(time.time(), int(step), summary=summary))

    def close(self):
        self.writer.close()
        self._py.close()
