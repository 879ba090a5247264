"""A padded Frame in host memory (pinned on a card), uploaded by the
harness as the program's input: the scan's points in the first lanes,
identity rotations, the circuit's pose.  The reference receives the same
host frame."""

import numpy as np
import torch

from benchmark import check, loopkit


class Feed(loopkit.FeedBase):
    def __init__(self, cfg, rcfg, traffic, scans, device):
        super().__init__(cfg, rcfg, traffic, scans, device)
        pin, P = self.pin, cfg.max_points
        N, n = self.n_frames, self.n_valid
        if n < P:
            pts = torch.zeros((N, P, 3), dtype=torch.float32, pin_memory=pin)
            inten = torch.zeros((N, P), dtype=torch.float32, pin_memory=pin)
            pts[:, :n] = scans.points
            inten[:, :n] = scans.intensity
        else:
            pts, inten = scans.points, scans.intensity
        hold = lambda a: (torch.from_numpy(np.array(a)).pin_memory() if pin
                          else torch.from_numpy(np.array(a)))
        self.points, self.intensity = pts, inten
        self.transforms, self.tracks = hold(self.T), hold(self.track)
        self.shared = dict(
            valid=hold(np.arange(P) < n),
            r_base_sensor=hold(np.eye(3, dtype=np.float32)),
            t_base_sensor=hold(np.zeros(3, np.float32)),
            r_map_base=hold(np.eye(3, dtype=np.float32)),
            pose_quat=hold(np.asarray([1.0, 0.0, 0.0, 0.0], np.float32)),
            pose_cov=hold(np.zeros((6, 6), np.float32)),
            colors=hold(np.zeros((P,), np.int32)),
            loop_closure=hold(np.zeros((), bool)))

    def host_frame(self, i: int):
        """Frame `i` of the circuit in host memory."""
        from gem_tpu_torch.mapping.pipeline import Frame

        return Frame(points=self.points[i], intensity=self.intensity[i],
                     transform=self.transforms[i],
                     t_map_base=self.tracks[i],
                     track_position=self.tracks[i], image=None,
                     **self.shared)

    def device_frame(self, i: int):
        from gem_tpu_torch.utils.tree import tree_map

        return tree_map(lambda t: t.to(self.device, non_blocking=True),
                        self.host_frame(i))

    def reference_frame(self, i: int):
        return check.to_reference(self.host_frame(i), self.device)
