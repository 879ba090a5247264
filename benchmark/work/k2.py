"""K2's work in a frame, from the reference's plane fit: (cells, fitted
cells), a fitted cell being one with an elevation and at least
`feature_min_neighbors` neighbours; what `yardstick.k2_bound` counts
from."""


def count(kind, args, rcfg):
    if kind != "plane_fit_features":
        return None
    elev, planes = args
    fitted = int(((elev != rcfg.map.invalid_elevation)
                  & (planes.neighbor_count
                     >= rcfg.map.feature_min_neighbors)).sum())
    return elev.numel(), fitted
