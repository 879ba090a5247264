"""Frames enqueued back to back, as a recorded drive is mapped offline: the
host waits only to keep `queue_depth` frames queued (and their sources
alive).  Reports `points_per_s`: the valid points of every frame of the
window over its wall time, which ends in a synchronise."""

import collections
import time

import torch

from benchmark import loopkit


class Loop(loopkit.FrameLoop):
    def window(self, seconds: float) -> dict:
        depth = int(self.traffic["queue_depth"])
        cuda = self.device.type == "cuda"
        pending = collections.deque()
        n = 0
        t_start = time.perf_counter()
        while True:
            g = self.k
            self._before(g)
            with self.rec.span("frame"):
                f, out = self.frame()
            if cuda:
                ev = torch.cuda.Event()
                ev.record()
                pending.append(ev)
            self._after(g, f, out)
            del f, out
            if len(pending) > depth:
                with self.rec.span("wait"):
                    pending.popleft().synchronize()
            self.k += 1
            n += 1
            if time.perf_counter() - t_start >= seconds \
                    and not self._pending():
                break
        with self.rec.span("sync"):
            loopkit.sync(self.device)
        wall = time.perf_counter() - t_start
        self.attempted = n
        return {"points_per_s": n * self.feed.n_valid / wall}
