"""A closed loop, one frame in flight: each frame is timed from the moment
the harness hands over the scan, still in host memory, until its outputs
are complete on the device (synchronised).  Reports `frame_ms_p95`, the
95th percentile over every frame of the window."""

import time

import numpy as np

from benchmark import loopkit


class Loop(loopkit.FrameLoop):
    def window(self, seconds: float) -> dict:
        times = []
        t_start = time.perf_counter()
        while True:
            g = self.k
            self._before(g)
            with self.rec.span("frame"):
                t0 = time.perf_counter()
                f, out = self.frame()
                with self.rec.span("sync"):
                    loopkit.sync(self.device)
                t1 = time.perf_counter()
            times.append(t1 - t0)
            self._after(g, f, out)
            self.k += 1
            if t1 - t_start >= seconds and not self._pending():
                break
        self.attempted = len(times)
        return {"frame_ms_p95": float(np.percentile(times, 95)) * 1e3}
