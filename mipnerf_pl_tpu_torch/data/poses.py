"""Camera-pose normalisations of LLFF-style real captures (numpy).

Counterpart of mipnerf_pl_tpu/data/poses.py, the same operations in the
same order.  Camera-to-world matrices are [3, 4] (or [3, 5] with an hwf
column), the camera axes as columns [right, up, forward]:

  * `recenter_poses` re-expresses every pose in the frame of the "average
    camera";
  * `spherify_poses` centres the world on the point closest to every
    camera's optical axis and turns +z to the cameras' mean up direction,
    the normalisation of inward-facing 360 captures.

Rigid transforms are inverted as (R^T, -R^T t), over the whole pose stack
at once.
"""

from __future__ import annotations

import numpy as np


def _unit(x, axis=-1):
    return x / np.linalg.norm(x, axis=axis, keepdims=True)


def camera_basis(forward, up, position) -> np.ndarray:
    """[3, 4] camera-to-world from a forward direction and an up hint:
    right = up x forward, true up = forward x right; columns [right, up,
    forward, position]."""
    fwd = _unit(forward)
    right = _unit(np.cross(up, fwd))
    true_up = _unit(np.cross(fwd, right))
    return np.stack([right, true_up, fwd, position], axis=-1)


def average_pose(poses: np.ndarray) -> np.ndarray:
    """The central camera of a stack [N, 3, 4+]: mean position, summed
    viewing direction and up -> [3, 4]."""
    return camera_basis(forward=poses[:, :3, 2].sum(0),
                        up=poses[:, :3, 1].sum(0),
                        position=poses[:, :3, 3].mean(0))


def _apply_world_transform(poses: np.ndarray, frame: np.ndarray):
    """(rotations [N, 3, 3], translations [N, 3]) of camera-to-world poses
    re-expressed in the frame of the [3, 4] camera-to-world `frame`."""
    rot_inv = frame[:3, :3].T
    t_inv = -rot_inv @ frame[:3, 3]
    new_rot = np.einsum('ij,njk->nik', rot_inv, poses[:, :3, :3])
    new_t = poses[:, :3, 3] @ rot_inv.T + t_inv
    return new_rot, new_t


def recenter_poses(poses: np.ndarray) -> np.ndarray:
    """Poses [N, 3, 5] in the frame of their average camera; the hwf
    column passes through."""
    new_rot, new_t = _apply_world_transform(poses, average_pose(poses))
    out = poses.copy()
    out[:, :3, :3] = new_rot
    out[:, :3, 3] = new_t
    return out


def focus_point(poses: np.ndarray) -> np.ndarray:
    """The least-squares point nearest to every optical axis o_i + s d_i:
    (sum_i P_i^T P_i) p = sum_i P_i^T P_i o_i with P_i = I - d_i d_i^T."""
    d = poses[:, :3, 2]
    o = poses[:, :3, 3]
    proj = np.eye(3) - d[:, :, None] * d[:, None, :]            # [N, 3, 3]
    lhs = np.einsum('nij,njk->ik', proj.transpose(0, 2, 1), proj)
    rhs = np.einsum('nij,njk,nk->i', proj.transpose(0, 2, 1), proj, o)
    return np.linalg.solve(lhs, rhs)


def spherify_poses(poses: np.ndarray) -> np.ndarray:
    """Poses [N, 3, 5] re-centred on the cameras' focus point with +z along
    their mean up; the first pose's hwf column goes to every pose, as in
    LLFF."""
    center = focus_point(poses)
    up = _unit((poses[:, :3, 3] - center).mean(0))
    # LLFF's fixed seed of the horizontal basis, so that a spherified
    # world is the one other LLFF tools produce.
    right = _unit(np.cross([0.1, 0.2, 0.3], up))
    fwd = _unit(np.cross(up, right))
    frame = np.stack([right, fwd, up, center], axis=-1)          # [3, 4]

    new_rot, new_t = _apply_world_transform(poses, frame)
    hwf = np.broadcast_to(poses[0, :3, -1:], (len(poses), 3, 1))
    return np.concatenate(
        [new_rot, new_t[:, :, None], hwf], axis=-1)
