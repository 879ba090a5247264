"""A raw scan through the program's `io/replay.py` `pad_frame`: the host
voxel filter of the native runtime (upstream's filter_kitti.launch), the
padding and the uploads, all on the timed path.  The reference filters and
pads the same raw scan itself (reference/intake.py).

The native library has to be the active path: `pad_frame` falls back to a
NumPy filter when it cannot be built or loaded, which would time another
filter; so the feed refuses to start without it."""

from benchmark import check, loopkit
from benchmark.reference import intake as r_intake


class Feed(loopkit.FeedBase):
    keeps_frame = True

    def __init__(self, cfg, rcfg, traffic, scans, device):
        from gem_tpu_torch import native

        super().__init__(cfg, rcfg, traffic, scans, device)
        if not native.available():
            raise RuntimeError("the native voxel filter is not available: "
                               "pad_frame would time its NumPy fallback")
        self.raw_points = scans.points.numpy()
        self.raw_intensity = scans.intensity.numpy()

    def device_frame(self, i: int):
        from gem_tpu_torch.io.replay import pad_frame

        return pad_frame(self.cfg, self.raw_points[i], self.raw_intensity[i],
                         transform=self.T[i], track_position=self.track[i],
                         device=self.device)

    def reference_frame(self, i: int):
        return r_intake.pad_frame(self.rcfg, self.raw_points[i],
                                  self.raw_intensity[i], self.T[i],
                                  self.track[i], self.device)

    def check_frame(self, ref_frame, frame) -> dict:
        """The filtered scan as a set (the filter's output order is the
        host runtime's hash order)."""
        return {"intake_gap": check.intake_gap(ref_frame, frame)}

    def pool(self, ref_frame):
        """A keyframe's stored scan subsamples the filtered points in the
        filter's output order: held by membership in them."""
        return check.filtered_points(ref_frame)
