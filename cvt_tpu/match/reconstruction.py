"""Scene graph: correspondence graph, tracks, and sparse reconstruction.

Reference: vlindex/src/base/{correspondence_graph,track,point3d,
reconstruction}.{h,cc} — COLMAP's scene model, kept by vlindex as the
substrate under feature matching (CorrespondenceGraph accumulates
pairwise matches; Track chains observations of one 3D point across
images; Reconstruction holds cameras/images/points3D).

Redesign: the graph itself is irregular pointer-chasing, so
it stays host-side (numpy union-find instead of the reference's per-node
adjacency lists, correspondence_graph.cc FindTransitiveCorrespondences);
everything numerical is batched on device — multi-view DLT triangulation
of ALL tracks in one padded [T, S] SVD batch, reprojection errors in one
gather + projection, refinement through match.bundle.bundle_adjust.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from cvt_tpu.match.bundle import BAProblem, bundle_adjust, rodrigues


# --------------------------------------------------------------------------
# correspondence graph + tracks (host-side)
# --------------------------------------------------------------------------

class CorrespondenceGraph:
    """Accumulates pairwise feature matches; extracts transitive tracks.

    Nodes are (image_id, point2d_idx) observations; `build_tracks` is
    union-find over all match edges (path compression + union by size),
    replacing the reference's recursive transitive walk."""

    def __init__(self):
        self._edges: List[Tuple[int, int, np.ndarray]] = []
        self._num_obs: Dict[int, int] = {}

    def add_correspondences(self, image_id1: int, image_id2: int,
                            matches) -> None:
        """matches: [N, 2] int array of (point2d_idx1, point2d_idx2)."""
        m = np.asarray(matches, np.int64).reshape(-1, 2)
        self._edges.append((int(image_id1), int(image_id2), m))
        for iid, col in ((image_id1, 0), (image_id2, 1)):
            hi = int(m[:, col].max(initial=-1)) + 1
            self._num_obs[iid] = max(self._num_obs.get(iid, 0), hi)

    @property
    def image_ids(self) -> List[int]:
        return sorted(self._num_obs)

    def num_correspondences(self, image_id: int) -> int:
        n = 0
        for i1, i2, m in self._edges:
            if image_id in (i1, i2):
                n += m.shape[0]
        return n

    def build_tracks(self, min_length: int = 2) -> List[np.ndarray]:
        """Return tracks as [len, 2] arrays of (image_id, point2d_idx).

        Tracks observing the same image twice are inconsistent and
        dropped, matching COLMAP's track-merge rule."""
        key_of: Dict[Tuple[int, int], int] = {}

        def node(iid: int, fid: int) -> int:
            k = (iid, fid)
            if k not in key_of:
                key_of[k] = len(key_of)
            return key_of[k]

        pairs = []
        for i1, i2, m in self._edges:
            for a, b in m:
                pairs.append((node(i1, int(a)), node(i2, int(b))))
        n = len(key_of)
        parent = np.arange(n, dtype=np.int64)

        def find(x: int) -> int:
            root = x
            while parent[root] != root:
                root = parent[root]
            while parent[x] != root:        # path compression
                parent[x], x = root, parent[x]
            return root

        for a, b in pairs:
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[rb] = ra

        groups: Dict[int, List[Tuple[int, int]]] = {}
        for (iid, fid), idx in key_of.items():
            groups.setdefault(find(idx), []).append((iid, fid))

        tracks = []
        for obs in groups.values():
            if len(obs) < min_length:
                continue
            imgs = [o[0] for o in obs]
            if len(set(imgs)) != len(imgs):   # same image twice -> drop
                continue
            tracks.append(np.asarray(sorted(obs), np.int64))
        tracks.sort(key=lambda t: (-len(t), t[0, 0], t[0, 1]))
        return tracks


# --------------------------------------------------------------------------
# batched geometry (device-side)
# --------------------------------------------------------------------------

@jax.jit
def triangulate_tracks(rots, tvecs, cam_idx, uv, mask):
    """Multi-view DLT for a padded batch of tracks, one SVD batch.

    rots [C,3,3], tvecs [C,3] world->camera; cam_idx [T,S] int,
    uv [T,S,2] normalized coords, mask [T,S] (0 pads). Returns
    (points [T,3], ok [T]) — ok requires >= 2 observations and positive
    depth in every observing camera (cheirality)."""
    p = jnp.concatenate([rots, tvecs[..., None]], axis=-1)     # [C,3,4]
    po = p[cam_idx]                                            # [T,S,3,4]
    u = uv[..., 0:1]
    v = uv[..., 1:2]
    r1 = u * po[..., 2, :] - po[..., 0, :]                     # [T,S,4]
    r2 = v * po[..., 2, :] - po[..., 1, :]
    a = jnp.concatenate([r1, r2], axis=1) * jnp.concatenate(
        [mask, mask], axis=1)[..., None]                       # [T,2S,4]
    # smallest right singular vector of A
    _, _, vt = jnp.linalg.svd(a, full_matrices=False)
    xh = vt[..., -1, :]                                        # [T,4]
    w = xh[..., 3:4]
    w = jnp.where(jnp.abs(w) < 1e-12, 1e-12, w)
    x = xh[..., :3] / w                                        # [T,3]
    cam_pts = jnp.einsum("tsij,tj->tsi", po[..., :3], x) + po[..., :, 3]
    depth_ok = jnp.all(jnp.where(mask > 0, cam_pts[..., 2] > 0, True),
                       axis=1)
    ok = depth_ok & (jnp.sum(mask, axis=1) >= 2)
    return x, ok


@jax.jit
def _track_errors(rots, tvecs, cam_idx, uv, mask, pts):
    """Reprojection error of pts [T,3] in each observing camera [T,S]."""
    cam = jnp.einsum("tsij,tj->tsi", rots[cam_idx], pts) + tvecs[cam_idx]
    z = jnp.where(jnp.abs(cam[..., 2:]) < 1e-9, 1e-9, cam[..., 2:])
    err = jnp.linalg.norm(cam[..., :2] / z - uv, axis=-1)
    return jnp.where(mask > 0, err, 0.0)


@jax.jit
def reprojection_errors(poses6, points, cam_idx, pt_idx, uv, mask):
    """Per-observation reprojection error (normalized coords), batched."""
    r = rodrigues(poses6[cam_idx, :3])
    cam = jnp.einsum("oij,oj->oi", r, points[pt_idx]) + poses6[cam_idx, 3:]
    z = jnp.where(jnp.abs(cam[..., 2:3]) < 1e-9, 1e-9, cam[..., 2:3])
    err = jnp.linalg.norm(cam[..., :2] / z - uv, axis=-1)
    return jnp.where(mask > 0, err, 0.0)


# --------------------------------------------------------------------------
# reconstruction container (host-side book-keeping, device-side math)
# --------------------------------------------------------------------------

@dataclass
class RegisteredImage:
    name: str
    camera_id: int
    rvec: np.ndarray                     # [3] world->camera
    tvec: np.ndarray                     # [3]
    keypoints: np.ndarray                # [K, 2] normalized camera coords


@dataclass
class Point3D:
    xyz: np.ndarray                      # [3]
    track: np.ndarray                    # [len, 2] (image_id, point2d_idx)
    error: float = 0.0


@dataclass
class Reconstruction:
    """Sparse scene: registered images + triangulated 3D points.

    Mirrors Reconstruction's public surface (reconstruction.h) at the
    scope vlindex uses: register, triangulate, filter, bundle-adjust."""

    images: Dict[int, RegisteredImage] = field(default_factory=dict)
    points3d: Dict[int, Point3D] = field(default_factory=dict)
    _next_pt: int = 0

    def register_image(self, image_id: int, name: str, rvec, tvec,
                       keypoints, camera_id: int = 0) -> None:
        self.images[int(image_id)] = RegisteredImage(
            name, camera_id, np.asarray(rvec, np.float64).reshape(3),
            np.asarray(tvec, np.float64).reshape(3),
            np.asarray(keypoints, np.float64).reshape(-1, 2))

    @property
    def num_points3d(self) -> int:
        return len(self.points3d)

    def _pose_arrays(self):
        ids = sorted(self.images)
        idx_of = {iid: i for i, iid in enumerate(ids)}
        poses = np.stack([np.concatenate([self.images[i].rvec,
                                          self.images[i].tvec])
                          for i in ids]).astype(np.float32)
        return ids, idx_of, poses

    def triangulate(self, tracks: List[np.ndarray],
                    max_error: float = 0.01) -> int:
        """Triangulate tracks (all registered observations), keep points
        with cheirality + mean reprojection error <= max_error. Returns
        the number of points added."""
        tracks = [t[np.isin(t[:, 0], list(self.images))] for t in tracks]
        tracks = [t for t in tracks if len(t) >= 2]
        if not tracks:
            return 0
        _, idx_of, poses = self._pose_arrays()
        s = max(len(t) for t in tracks)
        tn = len(tracks)
        cam_idx = np.zeros((tn, s), np.int32)
        uv = np.zeros((tn, s, 2), np.float32)
        mask = np.zeros((tn, s), np.float32)
        for ti, t in enumerate(tracks):
            for si, (iid, fid) in enumerate(t):
                cam_idx[ti, si] = idx_of[int(iid)]
                uv[ti, si] = self.images[int(iid)].keypoints[int(fid)]
                mask[ti, si] = 1.0
        rots = rodrigues(jnp.asarray(poses[:, :3]))
        tvs = jnp.asarray(poses[:, 3:])
        cam_idx_j, uv_j, mask_j = (jnp.asarray(cam_idx), jnp.asarray(uv),
                                   jnp.asarray(mask))
        pts, ok = triangulate_tracks(rots, tvs, cam_idx_j, uv_j, mask_j)
        errs = np.asarray(
            _track_errors(rots, tvs, cam_idx_j, uv_j, mask_j, pts))
        mean_err = errs.sum(1) / np.maximum(mask.sum(1), 1.0)
        pts, ok = np.asarray(pts), np.asarray(ok)
        added = 0
        for ti, t in enumerate(tracks):
            if ok[ti] and mean_err[ti] <= max_error:
                self.points3d[self._next_pt] = Point3D(
                    pts[ti], t, float(mean_err[ti]))
                self._next_pt += 1
                added += 1
        return added

    def to_ba_problem(self) -> Tuple[BAProblem, List[int], List[int]]:
        """Pack the scene into a static-shape BAProblem.

        Returns (problem, image_ids_in_order, point_ids_in_order)."""
        ids, idx_of, poses = self._pose_arrays()
        pt_ids = sorted(self.points3d)
        pt_of = {pid: i for i, pid in enumerate(pt_ids)}
        points = np.stack([self.points3d[p].xyz for p in pt_ids]).astype(
            np.float32)
        cam_idx, pt_idx, uv = [], [], []
        for pid in pt_ids:
            for iid, fid in self.points3d[pid].track:
                if int(iid) not in idx_of:
                    continue
                cam_idx.append(idx_of[int(iid)])
                pt_idx.append(pt_of[pid])
                uv.append(self.images[int(iid)].keypoints[int(fid)])
        o = len(cam_idx)
        prob = BAProblem(
            poses=jnp.asarray(poses),
            points=jnp.asarray(points),
            cam_idx=jnp.asarray(np.asarray(cam_idx, np.int32)),
            pt_idx=jnp.asarray(np.asarray(pt_idx, np.int32)),
            uv=jnp.asarray(np.asarray(uv, np.float32).reshape(o, 2)),
            mask=jnp.ones((o,), jnp.float32))
        return prob, ids, pt_ids

    def bundle_adjust(self, *, iters: int = 20,
                      n_fixed_poses: int = 1,
                      huber_delta: Optional[float] = None) -> float:
        """Global BA over all registered images + points; writes back."""
        if not self.points3d or not self.images:
            return 0.0          # empty scene: graceful no-op
        prob, ids, pt_ids = self.to_ba_problem()
        poses, points, cost = bundle_adjust(
            prob, iters=iters, n_fixed_poses=n_fixed_poses,
            huber_delta=huber_delta)
        poses, points = np.asarray(poses), np.asarray(points)
        for i, iid in enumerate(ids):
            self.images[iid].rvec = poses[i, :3].astype(np.float64)
            self.images[iid].tvec = poses[i, 3:].astype(np.float64)
        for i, pid in enumerate(pt_ids):
            self.points3d[pid].xyz = points[i].astype(np.float64)
        return float(cost)

    def filter_points(self, max_error: float) -> int:
        """Drop points whose mean reprojection error exceeds max_error
        (reconstruction.cc FilterPoints3DWithLargeReprojectionError)."""
        if not self.points3d or not self.images:
            return 0            # empty scene: graceful no-op
        prob, _, pt_ids = self.to_ba_problem()
        errs = np.asarray(reprojection_errors(
            prob.poses, prob.points, prob.cam_idx, prob.pt_idx, prob.uv,
            prob.mask))
        pt_idx = np.asarray(prob.pt_idx)
        removed = 0
        for i, pid in enumerate(pt_ids):
            sel = pt_idx == i
            if sel.any() and errs[sel].mean() > max_error:
                del self.points3d[pid]
                removed += 1
        return removed

    # -- image management (exe/image.cc RunImageDeleter/Filterer) ---------
    def find_image_id(self, name: str) -> Optional[int]:
        for iid, im in self.images.items():
            if im.name == name:
                return iid
        return None

    def num_observations(self, image_id: int) -> int:
        """Number of 3D points observing this image."""
        return sum(1 for p in self.points3d.values()
                   if int(image_id) in p.track[:, 0])

    def deregister_image(self, image_id: int) -> bool:
        """Remove an image and prune its observations from every track
        (Reconstruction::DeRegisterImage). Tracks that fall below two
        observations lose their 3D point. Returns False if absent."""
        image_id = int(image_id)
        if image_id not in self.images:
            return False
        del self.images[image_id]
        dead = []
        for pid, p in self.points3d.items():
            keep = p.track[:, 0] != image_id
            if keep.sum() < 2:
                dead.append(pid)
            else:
                p.track = p.track[keep]
        for pid in dead:
            del self.points3d[pid]
        return True

    def filter_images(self, min_num_observations: int = 10) -> int:
        """Deregister images observed by fewer than min_num_observations
        3D points (exe/image.cc:155-203 RunImageFilterer; the reference's
        focal-length-ratio checks belong to its pixel-space Camera layer
        — keypoints here are already in normalized camera coordinates,
        so only the observation-count criterion applies). Returns the
        number of images removed."""
        counts = {iid: 0 for iid in self.images}
        for p in self.points3d.values():
            for iid in np.unique(p.track[:, 0]):
                if int(iid) in counts:
                    counts[int(iid)] += 1
        drop = [iid for iid, c in counts.items()
                if c < min_num_observations]
        for iid in drop:
            self.deregister_image(iid)
        return len(drop)

    # -- persistence ------------------------------------------------------
    def save(self, path: str) -> None:
        """Serialize to one .npz (Reconstruction::Write's binary role)."""
        ids = sorted(self.images)
        kp_flat = (np.concatenate([self.images[i].keypoints.reshape(-1, 2)
                                   for i in ids])
                   if ids else np.zeros((0, 2)))
        kp_len = np.asarray([len(self.images[i].keypoints) for i in ids],
                            np.int64)
        pt_ids = sorted(self.points3d)
        tr_flat = (np.concatenate([self.points3d[p].track.reshape(-1, 2)
                                   for p in pt_ids])
                   if pt_ids else np.zeros((0, 2), np.int64))
        tr_len = np.asarray([len(self.points3d[p].track) for p in pt_ids],
                            np.int64)
        np.savez(
            path,
            image_ids=np.asarray(ids, np.int64),
            names=np.asarray([self.images[i].name for i in ids]),
            camera_ids=np.asarray([self.images[i].camera_id for i in ids],
                                  np.int64),
            rvecs=(np.stack([self.images[i].rvec for i in ids])
                   if ids else np.zeros((0, 3))),
            tvecs=(np.stack([self.images[i].tvec for i in ids])
                   if ids else np.zeros((0, 3))),
            kp_flat=kp_flat, kp_len=kp_len,
            pt_ids=np.asarray(pt_ids, np.int64),
            xyz=(np.stack([self.points3d[p].xyz for p in pt_ids])
                 if pt_ids else np.zeros((0, 3))),
            errors=np.asarray([self.points3d[p].error for p in pt_ids]),
            tr_flat=np.asarray(tr_flat, np.int64), tr_len=tr_len)

    @classmethod
    def load(cls, path: str) -> "Reconstruction":
        z = np.load(path, allow_pickle=False)
        rec = cls()
        off = 0
        for i, iid in enumerate(z["image_ids"]):
            n = int(z["kp_len"][i])
            rec.register_image(
                int(iid), str(z["names"][i]), z["rvecs"][i], z["tvecs"][i],
                z["kp_flat"][off:off + n],
                camera_id=int(z["camera_ids"][i]))
            off += n
        off = 0
        for i, pid in enumerate(z["pt_ids"]):
            n = int(z["tr_len"][i])
            rec.points3d[int(pid)] = Point3D(
                z["xyz"][i], z["tr_flat"][off:off + n].astype(np.int64),
                float(z["errors"][i]))
            off += n
        rec._next_pt = int(max(rec.points3d, default=-1)) + 1
        return rec
