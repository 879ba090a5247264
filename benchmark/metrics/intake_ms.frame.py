"""Mean host-clock time of the intake (`pad_frame`: the host voxel filter,
the padding and the uploads) per frame, over the window."""
from benchmark.tracing import mean_ms


def read(trace):
    return mean_ms(trace, "intake")
