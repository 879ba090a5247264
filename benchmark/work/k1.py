"""K1's work in a frame, from the reference's streaming aggregate: (cells,
points that lie in a cell, occupied cells), what `yardstick.k1_bound`
counts its least bytes from."""

from benchmark import yardstick


def count(kind, args, rcfg):
    if kind == "fuse_stream_aggregate":
        return yardstick.k1_counts(args[0])
    return None
