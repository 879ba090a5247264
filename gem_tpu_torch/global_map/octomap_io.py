# A copy of gem_tpu/global_map/octomap_io.py (the port reads nothing under gem_tpu/).
"""Octomap `.bt` (bonsai-tree binary) serialization of voxel grids.

The reference publishes its road/obstacle maps as binary octomap messages
consumable by external nav stacks (trees built in pointCloudtoOctomap,
src/ElevationMapping.cpp:1146-1174; published :502-512).  gem_tpu's dense
voxel pyramid (global_map/pyramid.py) is the TPU-native octree equivalent;
this module bridges to the octomap ECOSYSTEM by writing the base occupancy
level in the public `.bt` wire format, which any octomap-based consumer
(octovis, octomap_server, move_base costmap octomap layers) can read.

Format (octomap library, OcTreeBaseImpl::writeBinaryData — public spec):

    # Octomap OcTree binary file\n
    <comment lines starting with #>
    id OcTree\n
    size <node count>\n
    res <resolution>\n
    data\n
    <binary pre-order child-descriptor stream>

Each serialized node is 2 bytes = 8 children x 2 bits, children 0..3 in the
first byte, 4..7 in the second, child i at bit positions (2i, 2i+1)
LSB-first.  Pair values: 0b00 unknown, 0b10 occupied leaf, 0b01 free leaf,
0b11 child has children (written recursively after this node, in child
order).  The tree is 16 levels deep; coordinate -> key is
floor(coord / res) + 32768 per axis, and the child index at a node uses bit
b = 15 - depth of each axis key: idx = xbit | ybit<<1 | zbit<<2.

The writer prunes: a subtree whose every depth-16 leaf is occupied
collapses to one occupied leaf ("bonsai"), exactly like octomap's
prune()+writeBinary.  Free space is not tracked by the pyramid, so
non-occupied children serialize as unknown — a valid octomap that encodes
occupied-vs-unknown (the reference's trees likewise only insert occupied
hits at :1161-1170).
"""

from __future__ import annotations

import io
import os

import numpy as np

TREE_DEPTH = 16
TREE_MAX_VAL = 1 << (TREE_DEPTH - 1)      # 32768
_HEADER_FIRST = "# Octomap OcTree binary file"


def coords_to_keys(xs, ys, zs, resolution: float) -> np.ndarray:
    """World coordinates -> (N, 3) uint16 octree keys (octomap coordToKey)."""
    k = np.stack([np.floor(np.asarray(c) / resolution).astype(np.int64)
                  + TREE_MAX_VAL for c in (xs, ys, zs)], axis=1)
    if k.size and (k.min() < 0 or k.max() >= 2 * TREE_MAX_VAL):
        raise ValueError("coordinates exceed the octree's 16-bit key range "
                         f"(+-{TREE_MAX_VAL * resolution} m at res "
                         f"{resolution})")
    return k.astype(np.uint16)


def keys_to_coords(keys: np.ndarray, resolution: float) -> np.ndarray:
    """(N, 3) keys -> voxel-center world coordinates (octomap keyToCoord)."""
    return (keys.astype(np.float64) - TREE_MAX_VAL + 0.5) * resolution


def _serialize(keys: np.ndarray) -> tuple[bytes, int]:
    """Pre-order child-descriptor stream for unique depth-16 keys.

    Returns (stream, node_count) where node_count counts every serialized
    inner node plus every leaf (pruned or full-depth), octomap's `size`.
    """
    out = io.BytesIO()
    kx = keys[:, 0].astype(np.uint32)
    ky = keys[:, 1].astype(np.uint32)
    kz = keys[:, 2].astype(np.uint32)

    def node(kx, ky, kz, b) -> int:
        # b = key bit selecting this node's children; b == 0 means the
        # children are depth-16 leaves
        count = 1
        pair_vals = []
        child_sets = []
        cidx = ((kx >> b) & 1) | (((ky >> b) & 1) << 1) | (((kz >> b) & 1)
                                                           << 2)
        for i in range(8):
            m = cidx == i
            n = int(m.sum())
            if n == 0:
                pair_vals.append(0)           # unknown
                child_sets.append(None)
            elif b == 0 or n == (1 << b) ** 3:
                # depth-16 leaf, or a FULL subtree -> pruned occupied leaf
                pair_vals.append(2)           # occupied leaf
                child_sets.append(None)
                count += 1
            else:
                pair_vals.append(3)           # has children
                child_sets.append((kx[m], ky[m], kz[m]))
        b1 = sum(pair_vals[i] << (2 * i) for i in range(4))
        b2 = sum(pair_vals[i + 4] << (2 * i) for i in range(4))
        out.write(bytes([b1, b2]))
        for i in range(8):
            if child_sets[i] is not None:
                count += node(*child_sets[i], b - 1)
        return count

    if keys.shape[0] == 0:
        # octomap convention: an empty tree has size 0 and no stream —
        # size >= 1 promises a readable root descriptor, which a zero-byte
        # stream cannot honor (round-3 review finding)
        return b"", 0
    n_nodes = node(kx, ky, kz, TREE_DEPTH - 1)
    return out.getvalue(), n_nodes


def write_bt(path: str, xs, ys, zs, resolution: float) -> int:
    """Write occupied points (e.g. voxel centers) as a `.bt` octree.

    Returns the serialized node count."""
    keys = np.unique(coords_to_keys(xs, ys, zs, resolution), axis=0)
    stream, n_nodes = _serialize(keys)
    with open(path, "wb") as f:
        f.write((_HEADER_FIRST + "\n").encode())
        f.write(b"# (feel free to add / change comments, but leave the "
                b"first line as it is!)\n#\n")
        f.write(b"id OcTree\n")
        f.write(f"size {n_nodes}\n".encode())
        f.write(f"res {resolution!r}\n".encode())
        f.write(b"data\n")
        f.write(stream)
    return n_nodes


def write_voxelgrid_bt(path: str, occupancy: np.ndarray, origin,
                       resolution: float) -> int:
    """Write a dense (X, Y, Z) occupancy grid's voxel centers as `.bt`."""
    idx = np.argwhere(np.asarray(occupancy))
    xs = origin[0] + (idx[:, 0] + 0.5) * resolution
    ys = origin[1] + (idx[:, 1] + 0.5) * resolution
    zs = origin[2] + (idx[:, 2] + 0.5) * resolution
    return write_bt(path, xs, ys, zs, resolution)


_OT_FIRST = "# Octomap OcTree file"
_OCC_LOGODDS = 3.5          # octomap's clampingThresMax default (occupied)


def write_ot(path: str, xs, ys, zs, colors, resolution: float) -> int:
    """Write occupied colored points as an octomap `.ot` ColorOcTree.

    Full format (octomap AbstractOcTree::write + writeNodesRecurs): header
    first line "# Octomap OcTree file", id/size/res/data, then a pre-order
    stream of per-node DATA (occupancy log-odds f32-LE + r,g,b bytes for
    ColorOcTree) followed by one child-bitmask byte.  The reference
    publishes exactly this tree type (src/ElevationMapping.cpp:234-236).
    `colors` is packed 0xRRGGBB per point (voxel color = mean of its
    points).  Returns the node count."""
    import struct

    raw = coords_to_keys(xs, ys, zs, resolution)
    # unique voxels; mean color per voxel
    keys, inv = np.unique(raw, axis=0, return_inverse=True)
    cols = np.zeros(keys.shape[0], np.int64)
    if keys.shape[0]:
        c = np.asarray(colors, np.int64)
        sums_r = np.bincount(inv, (c >> 16) & 0xFF, keys.shape[0])
        sums_g = np.bincount(inv, (c >> 8) & 0xFF, keys.shape[0])
        sums_b = np.bincount(inv, c & 0xFF, keys.shape[0])
        n = np.bincount(inv, minlength=keys.shape[0]).astype(np.float64)
        cols = ((sums_r / n).astype(np.int64) << 16) \
            | ((sums_g / n).astype(np.int64) << 8) \
            | (sums_b / n).astype(np.int64)

    out = io.BytesIO()
    kx = keys[:, 0].astype(np.uint32)
    ky = keys[:, 1].astype(np.uint32)
    kz = keys[:, 2].astype(np.uint32)

    def node(kx, ky, kz, cols, b) -> int:
        count = 1
        r = int(np.mean((cols >> 16) & 0xFF)) if cols.size else 0
        g = int(np.mean((cols >> 8) & 0xFF)) if cols.size else 0
        bl = int(np.mean(cols & 0xFF)) if cols.size else 0
        out.write(struct.pack("<f", _OCC_LOGODDS))
        out.write(bytes([r, g, bl]))
        if b < 0:
            out.write(bytes([0]))
            return count
        cidx = ((kx >> b) & 1) | (((ky >> b) & 1) << 1) \
            | (((kz >> b) & 1) << 2)
        masks = [(cidx == i) for i in range(8)]
        mask = 0
        for i in range(8):
            if masks[i].any():
                mask |= 1 << i
        out.write(bytes([mask]))
        for i in range(8):
            m = masks[i]
            if m.any():
                count += node(kx[m], ky[m], kz[m], cols[m], b - 1)
        return count

    n_nodes = 0
    if keys.shape[0]:
        n_nodes = node(kx, ky, kz, cols, TREE_DEPTH - 1)
    with open(path, "wb") as f:
        f.write((_OT_FIRST + "\n").encode())
        f.write(b"# (feel free to add / change comments, but leave the "
                b"first line as it is!)\n#\n")
        f.write(b"id ColorOcTree\n")
        f.write(f"size {n_nodes}\n".encode())
        f.write(f"res {resolution!r}\n".encode())
        f.write(b"data\n")
        f.write(out.getvalue())
    return n_nodes


def read_ot(path: str):
    """Parse a `.ot` ColorOcTree -> (resolution, (N, 3) leaf keys,
    (N,) packed colors, header dict)."""
    import struct

    with open(path, "rb") as f:
        data = f.read()
    nl = data.index(b"\n")
    if data[:nl].decode().strip() != _OT_FIRST:
        raise ValueError("not an octomap .ot file")
    pos = nl + 1
    header = {}
    while True:
        nl = data.index(b"\n", pos)
        line = data[pos:nl].decode().strip()
        pos = nl + 1
        if line.startswith("#") or not line:
            continue
        if line == "data":
            break
        k, _, v = line.partition(" ")
        header[k] = v
    res = float(header["res"])
    leaves = []
    colors = []

    def parse(pos, px, py, pz, b):
        (val,) = struct.unpack("<f", data[pos:pos + 4])
        r, g, bl = data[pos + 4], data[pos + 5], data[pos + 6]
        mask = data[pos + 7]
        pos += 8
        if mask == 0:
            if val > 0:  # occupied leaf: expand to depth-16 keys
                span = 1 << (b + 1) if b >= 0 else 1
                gr = np.arange(span, dtype=np.uint32)
                gx, gy, gz = np.meshgrid(gr, gr, gr, indexing="ij")
                leaves.append(np.stack(
                    [(px + gx).ravel(), (py + gy).ravel(),
                     (pz + gz).ravel()], axis=1))
                colors.append(np.full(span ** 3,
                                      (r << 16) | (g << 8) | bl, np.int64))
            return pos
        for i in range(8):
            if mask & (1 << i):
                cx = px | ((i & 1) << b)
                cy = py | (((i >> 1) & 1) << b)
                cz = pz | (((i >> 2) & 1) << b)
                pos = parse(pos, cx, cy, cz, b - 1)
        return pos

    if pos < len(data):
        import sys

        old = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old, 10000))
        try:
            parse(pos, 0, 0, 0, TREE_DEPTH - 1)
        finally:
            sys.setrecursionlimit(old)
    keys = (np.concatenate(leaves, axis=0).astype(np.uint16)
            if leaves else np.zeros((0, 3), np.uint16))
    cols = (np.concatenate(colors) if colors else np.zeros(0, np.int64))
    header["size"] = int(header.get("size", 0))
    return res, keys, cols, header


def read_bt(path: str):
    """Parse a `.bt` file -> (resolution, (N, 3) uint16 occupied leaf keys,
    header dict).  Pruned occupied leaves are expanded to depth-16 keys, so
    write->read->keys round-trips exactly."""
    with open(path, "rb") as f:
        data = f.read()
    nl = data.index(b"\n")
    first = data[:nl].decode()
    if first.strip() != _HEADER_FIRST:
        raise ValueError(f"not an octomap .bt file: {first!r}")
    pos = nl + 1
    header = {}
    while True:
        nl = data.index(b"\n", pos)
        line = data[pos:nl].decode().strip()
        pos = nl + 1
        if line.startswith("#") or not line:
            continue
        if line == "data":
            break
        k, _, v = line.partition(" ")
        header[k] = v
    res = float(header["res"])
    n_nodes = int(header.get("size", 0))

    leaves = []

    def parse(pos, px, py, pz, b):
        """Consume one node at stream offset `pos`; prefix keys (px,py,pz)
        hold the bits above bit b.  Returns new offset."""
        b1, b2 = data[pos], data[pos + 1]
        pos += 2
        pairs = [(b1 >> (2 * i)) & 3 for i in range(4)] + \
                [(b2 >> (2 * i)) & 3 for i in range(4)]
        for i, v in enumerate(pairs):
            if v == 0:
                continue
            cx = px | ((i & 1) << b)
            cy = py | (((i >> 1) & 1) << b)
            cz = pz | (((i >> 2) & 1) << b)
            if v == 3:
                pos = parse(pos, cx, cy, cz, b - 1)
            elif v == 2:  # occupied leaf spanning 2^b voxels per axis
                span = 1 << b
                g = np.arange(span, dtype=np.uint32)
                gx, gy, gz = np.meshgrid(g, g, g, indexing="ij")
                leaves.append(np.stack([(cx + gx).ravel(), (cy + gy).ravel(),
                                        (cz + gz).ravel()], axis=1))
            # v == 1: free leaf — not produced by the writer; skipped
        return pos

    if pos < len(data):
        import sys

        old = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old, 10000))
        try:
            parse(pos, 0, 0, 0, TREE_DEPTH - 1)
        finally:
            sys.setrecursionlimit(old)
    keys = (np.concatenate(leaves, axis=0).astype(np.uint16)
            if leaves else np.zeros((0, 3), np.uint16))
    header["size"] = n_nodes
    return res, keys, header
