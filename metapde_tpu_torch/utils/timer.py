"""Wall-clock timing context manager (counterpart of
metapde_tpu/utils/timer.py).

Time device work with a barrier inside the block (torch.cuda.synchronize()
or a host read of a result): CUDA launches return before the work ends.
"""

import time


class Timer:
    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter()
        self.interval = self.end - self.start
        return False
