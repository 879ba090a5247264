"""MR_SLAM-lite: inter-robot loop detection and the joint pose graph.

Counterpart of gem_tpu/multirobot/loop_detect.py:

  1. every occupied merged submap slot gets a DiSCO signature
     (global_map/place_recognition.py);
  2. cross-robot candidates are screened by keyframe distance and the
     signatures' cosine similarity;
  3. each candidate's SE(2) factor: yaw seeded by the signatures' spectra,
     then a sweep of 13 yaw hypotheses, each a de-rotated cartesian BEV
     phase-correlated against the other submap's, as one batched FFT; the
     best peak gives yaw and translation, verified by the peak height; the
     vertical offset is the median height difference of the co-located
     aligned cells;
  4. a per-robot-pair drift consensus, then the SE(2) pose graph (Gauss-
     Newton) and the decoupled linear z graph over all keyframes, on the
     host in NumPy (these functions are copies of the JAX package's, which
     use no JAX);
  5. the optimised poses re-stitch the merged store
     (global_map/loop_closure.py).

Conventions, as in the JAX package: relative_yaw(F_b, F_a) returns +yaw when
scene_b = R(+yaw) @ scene_a; phase_correlate_2d(img_a, img_b) returns d with
img_a(p) ~ img_b(p - d), in cells, wrapped to +-G/2.  The reference runs the
BEV rasterisation under `jit`, where `dx / res` with a constant `res`
becomes `dx * f32(1/res)`: the port multiplies by `f32_recip(res)` so cell
indices agree.  cuFFT, pocketfft and XLA's FFT differ in their last bits,
so the port holds to the reference by outcome (loops, pairs, factors), not
bitwise.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from gem_tpu_torch.global_map import submaps as sm
from gem_tpu_torch.global_map.loop_closure import apply_loop_closure
from gem_tpu_torch.global_map.place_recognition import (disco_signature,
                                                        match_signatures,
                                                        relative_yaw)
from gem_tpu_torch.msgs import InterPRRecord, InterPRsRecord
from gem_tpu_torch.utils.precision import f32_recip

_FIELDS = ("x", "y", "z", "variance", "intensity", "traver", "color",
           "valid")


def _yaw_of_quat(q):
    """Yaw of [qw, qx, qy, qz]."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return np.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))


def _quat_of_yaw(yaw):
    return np.stack([np.cos(yaw / 2), np.zeros_like(yaw),
                     np.zeros_like(yaw), np.sin(yaw / 2)], axis=-1)


def _quat_mul(a, b):
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return np.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw], axis=-1)


def _bev_raw(buf: sm.PointBuffer, center_xy, radius: float, grid: int,
             yaw=0.0):
    """(G, G) absolute max-z image of `buf` around `center_xy`, the local
    offsets de-rotated by -yaw first (row 0 = -x edge); empty cells are
    -inf.  `yaw` may be a float or an f32 tensor of shape (H,), which gives
    (H, G, G): one image per yaw in one scatter."""
    dev = buf.x.device
    yaw_t = torch.as_tensor(yaw, dtype=torch.float32, device=dev)
    batched = yaw_t.dim() == 1
    yaw_t = yaw_t.reshape(-1, 1)
    dx0 = buf.x - center_xy[0]
    dy0 = buf.y - center_xy[1]
    c, s = torch.cos(-yaw_t), torch.sin(-yaw_t)
    dx = dx0 * c - dy0 * s
    dy = dx0 * s + dy0 * c
    inv = f32_recip(2.0 * radius / grid)
    ix = torch.floor(dx * inv + grid / 2).to(torch.int64)
    iy = torch.floor(dy * inv + grid / 2).to(torch.int64)
    ok = buf.valid & (ix >= 0) & (ix < grid) & (iy >= 0) & (iy < grid)
    H, cells = yaw_t.shape[0], grid * grid + 1
    flat = torch.where(ok, ix * grid + iy, grid * grid) \
        + cells * torch.arange(H, device=dev)[:, None]
    img = torch.full((H * cells,), -math.inf, dtype=torch.float32,
                     device=dev)
    img.scatter_reduce_(0, flat.reshape(-1),
                        torch.where(ok, buf.z, -math.inf).reshape(-1),
                        "amax")
    img = img.reshape(H, cells)[:, :-1].reshape(H, grid, grid)
    return img if batched else img[0]


def cartesian_bev(buf: sm.PointBuffer, center_xy, radius: float, grid: int,
                  yaw=0.0):
    """(G, G) height image of `buf` around `center_xy` (the encoding of
    place_recognition.polar_bev: 1 + z - zmin, empty cells 0), de-rotated
    by -yaw; a (H,) tensor of yaws gives (H, G, G)."""
    zmin = torch.where(buf.valid, buf.z, math.inf).min()
    raw = _bev_raw(buf, center_xy, radius, grid, yaw=yaw)
    return torch.clamp(
        raw + 1.0 - torch.where(torch.isfinite(zmin), zmin, 0.0), min=0.0)


def phase_correlate_2d(img_a, img_b):
    """(dx_cells, dy_cells, peak) with img_a(p) ~ img_b(p - d); the peak is
    the normalised correlation height used for verification.  Leading
    batch dimensions broadcast: (..., G, G) in, (...,) tensors out."""
    Fa = torch.fft.fft2(img_a)
    Fb = torch.fft.fft2(img_b)
    cross = Fa * torch.conj(Fb)
    corr = torch.fft.ifft2(cross / (cross.abs() + 1e-9)).real
    G = corr.shape[-1]
    flat = corr.reshape(corr.shape[:-2] + (G * G,))
    idx = torch.argmax(flat, dim=-1, keepdim=True)   # ties: first, as jnp
    dx, dy = idx // G, idx % G
    at = lambda x, y: flat.gather(-1, (x % G) * G + (y % G))

    def refine(c_m, c_0, c_p):
        denom = c_m - 2 * c_0 + c_p
        d = torch.where(denom.abs() > 1e-12, 0.5 * (c_m - c_p) / denom,
                        torch.zeros_like(denom))
        return torch.clamp(d, -0.5, 0.5)

    c0 = at(dx, dy)
    ddx = refine(at(dx - 1, dy), c0, at(dx + 1, dy))
    ddy = refine(at(dx, dy - 1), c0, at(dx, dy + 1))
    wrap = lambda d: torch.where(d > G // 2, d - G, d).to(torch.float32)
    return ((wrap(dx) + ddx)[..., 0], (wrap(dy) + ddy)[..., 0], c0[..., 0])


@dataclasses.dataclass
class InterLoop:
    """A verified inter-robot loop factor between merged keyframes i, j:
    applying (yaw, t) to j's submap aligns it onto i's."""

    i: int
    j: int
    yaw: float                 # j's frame is i's rotated by +yaw
    t: np.ndarray              # (2,) translation (see factor_se2)
    similarity: float
    peak: float
    # vertical offset: median over co-located aligned BEV cells of
    # (z_i - z_j) = drift_i - drift_j (the reference's loop corrections
    # carry a height offset through Map_optmove, gpu_process.cu:1195-1254;
    # without this an injected z drift is never corrected in-framework —
    # round-4 verdict missing #1).  z_cells is the overlap support; a loop
    # with z_cells below the caller's floor contributes no z edge.
    dz: float = 0.0
    z_cells: int = 0

    def factor_se2(self):
        """Wire-format factor (dx, dy, dyaw): node j's TRUE position is
        c_i + t and its yaw correction is -yaw.  Sign convention pinned
        numerically (tests/test_loop_detect.py): phase_correlate_2d
        returns d with img_i(p) = img_j(p - d), and for drifted frames
        that evaluates to d*res = c_j_true - c_i."""
        return np.asarray([self.t[0], self.t[1], -self.yaw], np.float64)


def _slot(store: sm.SubmapStore, k: int) -> sm.PointBuffer:
    return sm.PointBuffer(**{f: getattr(store.slots, f)[k] for f in _FIELDS})


def detect_inter_loops(store: sm.SubmapStore, robot_of: np.ndarray, cfg,
                       sim_threshold: float = 0.93,
                       peak_threshold: float = 0.05,
                       max_pairs: int = 16,
                       bev_radius: float | None = None,
                       bev_grid: int = 128,
                       center_gate: float | None = None) -> list[InterLoop]:
    """Screen cross-robot submap pairs by DiSCO similarity, estimate and
    verify an SE(2) factor for the survivors.

    `store` is a merged fleet store (kf_ids = merged order); `robot_of`
    maps merged index -> robot id.  Returns at most `max_pairs` verified
    loops, strongest first.  The candidate gate is cross-robot, similarity
    at least `sim_threshold` and believed keyframe distance within
    `center_gate` (default 0.4 * radius: farther vantage points bias the
    translation estimate; drift adds to the believed distance)."""
    n = int(store.num_submaps)
    if n < 2:
        return []
    radius = bev_radius or cfg.submap.overlap_radius
    dev = store.centers.device
    centers = store.centers[:n].cpu().numpy()
    centers_t = store.centers[:n]

    sigs, ffts = [], []
    for k in range(n):
        s, fr, fi = disco_signature(_slot(store, k), centers_t[k],
                                    max_radius=radius)
        sigs.append(s)
        ffts.append((fr, fi))

    gate = center_gate if center_gate is not None else 0.4 * radius
    cand = []
    for i in range(n):
        for j in range(i + 1, n):
            if robot_of[i] == robot_of[j]:
                continue
            if np.linalg.norm(centers[i] - centers[j]) > gate:
                continue
            sim = float(match_signatures(sigs[i], sigs[j]))
            if sim >= sim_threshold:
                cand.append((sim, i, j))
    cand.sort(reverse=True)

    # the DiSCO yaw is only a seed: sweep 13 hypotheses around it and keep
    # the one whose de-rotated cartesian phase correlation peaks highest
    n_sectors = 64
    sweep = torch.tensor((2 * math.pi / n_sectors)
                         * np.linspace(-2.0, 2.0, 13), dtype=torch.float32,
                         device=dev)

    def align(buf_i, buf_j, ci, cj, yaw0):
        img_i = cartesian_bev(buf_i, ci, radius, bev_grid)
        yaws = yaw0 + sweep
        img_j = cartesian_bev(buf_j, cj, radius, bev_grid, yaw=yaws)
        dxs, dys, peaks = phase_correlate_2d(img_i, img_j)
        k = torch.argmax(peaks)
        return dxs[k], dys[k], peaks[k], yaws[k]

    loops: list[InterLoop] = []
    res = 2.0 * radius / bev_grid
    for sim, i, j in cand[:4 * max_pairs]:
        fr_i, fi_i = ffts[i]
        fr_j, fi_j = ffts[j]
        yaw0 = torch.tensor(float(relative_yaw(fr_j, fi_j, fr_i, fi_i)),
                            dtype=torch.float32, device=dev)
        buf_i, buf_j = _slot(store, i), _slot(store, j)
        dx, dy, peak, yaw = (float(v) for v in align(
            buf_i, buf_j, centers_t[i], centers_t[j], yaw0))
        if peak < peak_threshold:
            continue
        t = np.asarray([dx * res, dy * res])
        # z offset over co-located cells: img_i(p) = img_j(p - d), so
        # rolling img_j by the (integer) displacement aligns it onto i;
        # absolute max-z images (no zmin normalisation) keep raw heights
        z_i = _bev_raw(buf_i, centers_t[i], radius, bev_grid,
                       yaw=0.0).cpu().numpy()
        z_j = _bev_raw(buf_j, centers_t[j], radius, bev_grid,
                       yaw=yaw).cpu().numpy()
        z_j = np.roll(z_j, (int(round(dx)), int(round(dy))), axis=(0, 1))
        both = np.isfinite(z_i) & np.isfinite(z_j)
        dz = float(np.median(z_i[both] - z_j[both])) if both.any() else 0.0
        loops.append(InterLoop(i=i, j=j, yaw=yaw, t=t, similarity=sim,
                               peak=peak, dz=dz, z_cells=int(both.sum())))
        if len(loops) >= max_pairs:
            break
    return loops


def _implied_drift(lp: InterLoop, xyt: np.ndarray):
    """The rigid drift D of robot(j)'s frame implied by this loop
    (believed = D(true)): D_yaw = yaw, D_t = c_j - R(yaw) @ c_j_true with
    c_j_true = c_i + t."""
    ci, cj = xyt[lp.i][:2], xyt[lp.j][:2]
    true_j = ci + lp.t
    c, s = math.cos(lp.yaw), math.sin(lp.yaw)
    R = np.asarray([[c, -s], [s, c]])
    return lp.yaw, cj - R @ true_j


def _drift_consensus(loops: list, xyt: np.ndarray, robot_of: np.ndarray,
                     yaw_tol: float = 0.15, t_tol: float = 2.5):
    """PER-ROBOT-PAIR consensus: within each (robot a, robot b) pair, keep
    the largest cluster of loops whose implied rigid drifts agree (greedy,
    ties by summed similarity), and feed the union of all pairs' winners to
    the pose graph.  A single global winner would discard every verified
    loop between OTHER robot pairs in a 3+ robot fleet, leaving those
    robots permanently misaligned (round-4 advisor finding)."""
    if len(loops) <= 1:
        return loops
    drifts = [(lp, robot_of[lp.i], robot_of[lp.j], *_implied_drift(lp, xyt))
              for lp in loops]
    kept: list = []
    for pair in sorted({(int(a), int(b)) for (_, a, b, _, _) in drifts}):
        pair_drifts = [d for d in drifts if (int(d[1]), int(d[2])) == pair]
        best: list = []
        best_score = -1.0
        for (_, _, _, yaw0, t0) in pair_drifts:
            cluster = [lp for (lp, _, _, yaw, t) in pair_drifts
                       if abs((yaw - yaw0 + math.pi) % (2 * math.pi)
                              - math.pi) < yaw_tol
                       and np.linalg.norm(t - t0) < t_tol]
            score = len(cluster) * 1000 + sum(lp.similarity
                                              for lp in cluster)
            if score > best_score:
                best, best_score = cluster, score
        kept.extend(best)
    return kept


def _v2t(v):
    c, s = math.cos(v[2]), math.sin(v[2])
    return np.asarray([[c, -s, v[0]], [s, c, v[1]], [0, 0, 1]], np.float64)


def _t2v(T):
    return np.asarray([T[0, 2], T[1, 2], math.atan2(T[1, 0], T[0, 0])],
                      np.float64)


def optimize_pose_graph(nodes_xyt: np.ndarray, edges: list,
                        anchor: int = 0, iters: int = 25,
                        damping: float = 1e-6) -> np.ndarray:
    """Dense SE(2) pose-graph Gauss-Newton (numpy; N = fleet keyframes).

    nodes_xyt : (N, 3) initial (x, y, yaw)
    edges     : list of (i, j, z_xyt, weight) — z = pose of j in i's frame
    Returns optimized (N, 3).  The anchor node is held fixed (the
    reference holds keyframe 0 rigid the same way,
    src/ElevationMapping.cpp:794).
    """
    x = np.asarray(nodes_xyt, np.float64).copy()
    N = x.shape[0]
    for _ in range(iters):
        H = np.zeros((3 * N, 3 * N))
        b = np.zeros(3 * N)
        for (i, j, z, w) in edges:
            Ti, Tj, Tz = _v2t(x[i]), _v2t(x[j]), _v2t(z)
            e = _t2v(np.linalg.inv(Tz) @ np.linalg.inv(Ti) @ Tj)
            # angle wrap
            e[2] = (e[2] + math.pi) % (2 * math.pi) - math.pi
            ci, si = math.cos(x[i][2]), math.sin(x[i][2])
            Rti = np.asarray([[ci, si], [-si, ci]])     # R_i^T
            Rz = Tz[:2, :2]
            dt = x[j][:2] - x[i][:2]
            A = np.zeros((3, 3))
            A[:2, :2] = -Rz.T @ Rti
            A[:2, 2] = Rz.T @ np.asarray([[-si, ci], [-ci, -si]]) @ dt
            A[2, 2] = -1.0
            B = np.zeros((3, 3))
            B[:2, :2] = Rz.T @ Rti
            B[2, 2] = 1.0
            Hii = w * A.T @ A
            Hjj = w * B.T @ B
            Hij = w * A.T @ B
            sl = lambda k: slice(3 * k, 3 * k + 3)
            H[sl(i), sl(i)] += Hii
            H[sl(j), sl(j)] += Hjj
            H[sl(i), sl(j)] += Hij
            H[sl(j), sl(i)] += Hij.T
            b[sl(i)] += w * A.T @ e
            b[sl(j)] += w * B.T @ e
        # anchor prior
        H[3 * anchor:3 * anchor + 3, 3 * anchor:3 * anchor + 3] += \
            1e9 * np.eye(3)
        H += damping * np.eye(3 * N)
        try:
            dx = np.linalg.solve(H, -b)
        except np.linalg.LinAlgError:
            break
        x += dx.reshape(N, 3)
        x[:, 2] = (x[:, 2] + math.pi) % (2 * math.pi) - math.pi
        if np.max(np.abs(dx)) < 1e-9:
            break
    return x


def optimize_z_graph(z0: np.ndarray, edges: list, anchor: int = 0,
                     damping: float = 1e-9) -> np.ndarray:
    """Vertical DOF of the pose graph.  z decouples EXACTLY from SE(2) (a
    planar rotation never mixes z), so instead of inflating the GN state to
    SE(2)xR it solves the 1-D linear graph in closed form:

        minimize  sum_edges w * ((z_j - z_i) - m)^2   with z[anchor] fixed

    edges: (i, j, m, w) with m = the measured relative z (for odometry
    edges the believed delta; for loop edges believed delta + dz, see
    fleet_loop_closure).  Mirrors the reference's loop-correction height
    offset (Map_optmove / G_update_mapheight, gpu_process.cu:1195-1254)
    estimated in-framework instead of taken from external poses."""
    z = np.asarray(z0, np.float64).copy()
    N = z.shape[0]
    H = np.zeros((N, N))
    b = np.zeros(N)
    for (i, j, m, w) in edges:
        # residual r = (z_j - z_i) - m; J_i = -1, J_j = +1
        H[i, i] += w
        H[j, j] += w
        H[i, j] -= w
        H[j, i] -= w
        r = (z[j] - z[i]) - m
        b[i] += -w * r
        b[j] += w * r
    H[anchor, anchor] += 1e9
    H += damping * np.eye(N)
    try:
        dz = np.linalg.solve(H, -b)
    except np.linalg.LinAlgError:
        return z
    return z + dz


def interpr_records(loops: list[InterLoop], store: sm.SubmapStore,
                    seq: int = 0) -> InterPRsRecord:
    """Wire-format batch of the verified candidates
    (dislam_msgs/InterPRs.msg: id0/id1 + factor pose)."""
    poses = store.poses.cpu().numpy()
    items = []
    for lp in loops:
        f = lp.factor_se2()
        factor = np.zeros(7, np.float32)
        factor[:2] = f[:2]
        factor[2] = lp.dz
        factor[3:] = _quat_of_yaw(np.asarray(f[2]))
        items.append(InterPRRecord(
            id0=lp.i, id1=lp.j, is_aerial=False, is_checked=True,
            id0_pose=poses[lp.i].astype(np.float32), factor_pose=factor))
    return InterPRsRecord(seq=seq, items=items)


def fleet_loop_closure(fleet_store: sm.SubmapStore, cfg,
                       sim_threshold: float = 0.93,
                       peak_threshold: float = 0.05,
                       loop_weight: float = 10.0,
                       max_pairs: int = 16,
                       center_gate: float | None = None,
                       min_z_cells: int = 16):
    """End to end: merge the fleet's submap rings, detect inter-robot loops
    from DiSCO signatures alone, optimise the joint keyframe pose graph
    (SE(2) Gauss-Newton + the decoupled linear z graph) and re-stitch the
    merged map.  `center_gate` as in `detect_inter_loops`.

    Returns (corrected merged store, stats dict, InterPRsRecord).  With no
    verified loop the merged store is returned unchanged (stats say why).
    """
    from gem_tpu_torch.multirobot.exchange import merge_fleet_stores

    merged, (r_idx, _) = merge_fleet_stores(fleet_store, cfg,
                                            return_mapping=True)
    n = int(merged.num_submaps)
    if n < 2:
        return merged, {"n_loops": 0, "reason": "fewer than 2 submaps"}, \
            InterPRsRecord(seq=0, items=[])
    robot_of = np.asarray(r_idx)
    loops = detect_inter_loops(merged, robot_of, cfg,
                               sim_threshold=sim_threshold,
                               peak_threshold=peak_threshold,
                               max_pairs=max_pairs,
                               center_gate=center_gate)
    records = interpr_records(loops, merged)
    if not loops:
        return merged, {"n_loops": 0, "reason": "no candidate above "
                        f"similarity {sim_threshold}"}, records

    poses = merged.poses.cpu().numpy()[:n]
    xyt = np.zeros((n, 3))
    xyt[:, :2] = poses[:, :2]
    xyt[:, 2] = _yaw_of_quat(poses[:, 3:])

    # every true loop between one robot pair implies the same rigid drift;
    # keep each pair's largest agreeing cluster
    loops = _drift_consensus(loops, xyt, robot_of)
    records = interpr_records(loops, merged)
    if not loops:
        return merged, {"n_loops": 0,
                        "reason": "no drift-consistent loop cluster"}, \
            records

    edges = []
    for k in range(n - 1):          # odometry edges within each robot
        if robot_of[k] != robot_of[k + 1]:
            continue
        z = _t2v(np.linalg.inv(_v2t(xyt[k])) @ _v2t(xyt[k + 1]))
        edges.append((k, k + 1, z, 1.0))
    for lp in loops:
        # node j's true world pose is (c_i + t, yaw_j - yaw), relative to i
        ci, cj = xyt[lp.i], xyt[lp.j]
        corr_j = np.asarray([ci[0] + lp.t[0], ci[1] + lp.t[1],
                             cj[2] - lp.yaw])
        z = _t2v(np.linalg.inv(_v2t(ci)) @ _v2t(corr_j))
        edges.append((lp.i, lp.j, z, loop_weight))

    opt_xyt = optimize_pose_graph(xyt, edges)

    # vertical DOF: odometry edges carry the believed delta, loop edges the
    # believed delta corrected by the measured offset dz = drift_i - drift_j
    e_z = poses[:, 2].astype(np.float64)
    z_edges = []
    for k in range(n - 1):
        if robot_of[k] == robot_of[k + 1]:
            z_edges.append((k, k + 1, e_z[k + 1] - e_z[k], 1.0))
    n_z_loops = 0
    for lp in loops:
        if lp.z_cells >= min_z_cells:
            z_edges.append((lp.i, lp.j, e_z[lp.j] - e_z[lp.i] + lp.dz,
                            loop_weight))
            n_z_loops += 1
    opt_z = optimize_z_graph(e_z, z_edges) if n_z_loops else e_z

    opt_poses = poses.copy()
    opt_poses[:, :2] = opt_xyt[:, :2]
    opt_poses[:, 2] = opt_z
    dyaw = opt_xyt[:, 2] - xyt[:, 2]
    opt_poses[:, 3:] = _quat_mul(_quat_of_yaw(dyaw), poses[:, 3:])

    joint_cfg = cfg.replace(submap=dataclasses.replace(
        cfg.submap, max_submaps=merged.counts.shape[0]))
    corrected, lc_stats = apply_loop_closure(merged, joint_cfg,
                                             opt_poses.astype(np.float32))
    stats = {"n_loops": len(loops),
             "pairs": [(lp.i, lp.j) for lp in loops],
             "similarities": [round(lp.similarity, 4) for lp in loops],
             "peaks": [round(lp.peak, 4) for lp in loops],
             "implied_drifts": [
                 (round(math.degrees(d[0]), 2),
                  round(float(d[1][0]), 2), round(float(d[1][1]), 2))
                 for d in (_implied_drift(lp, xyt) for lp in loops)],
             "loop_dz_m": [round(lp.dz, 3) for lp in loops],
             "n_z_loops": n_z_loops,
             "max_pose_correction_m": float(np.max(np.linalg.norm(
                 opt_xyt[:, :2] - xyt[:, :2], axis=1))),
             "max_z_correction_m": float(np.max(np.abs(opt_z - e_z))),
             **lc_stats}
    return corrected, stats, records
