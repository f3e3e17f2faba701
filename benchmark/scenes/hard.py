"""The scene every kind draws: textured spheres over a checkered ground
disk, ray-traced analytically (a frozen copy of the port's synthetic
'hard' scene, kept here so that a change to the port cannot move the
benchmark's inputs).  The tracer runs in torch on the run's device, so an
800x800 view takes milliseconds; the PNGs are written with PIL.  The seed
draws the camera orbit (its phase and each view's jitter); every size is
the configuration's, so every seed gives the same work."""

from __future__ import annotations

import math

import numpy as np
import torch

CAMERA_ANGLE_X = 0.6911112070083618  # NeRF-synthetic's
ORBIT_RADIUS = 4.0
ELEVATION = math.pi / 5.0

# (center, radius, color, texture kind, texture frequency).
HARD_SPHERES = [
    ((0.0, 0.0, 0.1), 0.7, (0.95, 0.3, 0.25), 'checker', 9.0),
    ((0.95, 0.0, -0.1), 0.35, (0.2, 0.85, 0.35), 'stripes', 22.0),
    ((-0.65, 0.7, -0.2), 0.3, (0.3, 0.4, 0.95), 'checker', 16.0),
    ((0.1, -0.95, -0.25), 0.32, (0.95, 0.8, 0.25), 'rings', 18.0),
]
# Ground disk: (z, disk radius, color, kind, frequency).
HARD_GROUND = (-0.65, 2.8, (0.82, 0.82, 0.85), 'checker', 2.5)


def orbit_poses(n: int, seed: int, split: int = 0,
                radius: float = ORBIT_RADIUS):
    """[n, 3, 4] camera-to-world poses looking at the origin, +z up, around
    a circle at 36 degrees elevation: the first at an angle drawn from the
    seed, each angle and elevation jittered (a hand-held capture; an
    exactly even orbit leaves LLFF's average camera without a defined
    right axis)."""
    rng = np.random.default_rng([int(seed), 1, split])
    t = (rng.uniform(0.0, 2 * np.pi)
         + np.linspace(0.0, 2.0 * np.pi, n + 1)[:-1]
         + rng.uniform(-0.3, 0.3, n) * np.pi / max(n, 1))
    elev = ELEVATION + rng.uniform(-0.08, 0.08, n)
    st, ct = np.sin(t), np.cos(t)
    se, ce = np.sin(elev), np.cos(elev)
    right = np.stack([-ct, st, np.zeros_like(t)], axis=-1)
    up = np.stack([-st * se, -ct * se, ce], axis=-1)
    forward = np.stack([st * ce, ct * ce, se], axis=-1)
    return np.stack([right, up, forward, radius * forward], axis=-1)


def _texture(pt, kind: str, freq: float):
    if kind == 'checker':
        parity = torch.remainder(torch.floor(pt * freq).sum(-1), 2)
    elif kind == 'stripes':
        parity = torch.remainder(torch.floor(pt[..., 2] * freq), 2)
    elif kind == 'rings':
        parity = torch.remainder(
            torch.floor(torch.hypot(pt[..., 0], pt[..., 1]) * freq), 2)
    else:
        raise ValueError(f'unknown texture kind {kind!r}')
    return 0.2 + 0.8 * parity


def render_hard_view(c2w: np.ndarray, width: int, height: int, focal: float,
                     device) -> np.ndarray:
    """The 'hard' scene from pose c2w [3, 4]: [height, width, 4] straight
    RGBA in [0, 1] (alpha 0 where the ray misses)."""
    f32 = torch.float32
    rot = torch.as_tensor(np.asarray(c2w)[:3, :3], dtype=f32, device=device)
    o = torch.as_tensor(np.asarray(c2w)[:3, 3], dtype=f32, device=device)
    x = torch.arange(width, dtype=f32, device=device) + 0.5
    y = torch.arange(height, dtype=f32, device=device) + 0.5
    cam = torch.stack(torch.broadcast_tensors(
        ((x - width / 2) / focal)[None, :],
        (-(y - height / 2) / focal)[:, None],
        torch.full((1, 1), -1.0, dtype=f32, device=device)), -1)
    dirs = cam @ rot.T                                          # [H, W, 3]
    rgba = torch.zeros(height, width, 4, dtype=f32, device=device)
    tmin = torch.full((height, width), math.inf, dtype=f32, device=device)
    light = torch.tensor([0.5, 0.5, 0.7], dtype=f32, device=device)
    for center, r, color, kind, freq in HARD_SPHERES:
        c = torch.tensor(center, dtype=f32, device=device)
        oc = o - c
        b = (dirs * oc).sum(-1)
        dd = (dirs * dirs).sum(-1)
        disc = b * b - dd * ((oc * oc).sum() - r * r)
        t = (-b - torch.sqrt(torch.clamp(disc, min=0))) / dd
        closer = (disc > 0) & (t > 0) & (t < tmin)
        tmin = torch.where(closer, t, tmin)
        pt = o + dirs * t[..., None]
        shade = 0.4 + 0.6 * torch.clamp((pt - c) / r @ light, 0, 1)
        shade = shade * _texture(pt - c, kind, freq)
        for k in range(3):
            rgba[..., k] = torch.where(closer, color[k] * shade,
                                       rgba[..., k])
        rgba[..., 3] = torch.where(closer, 1.0, rgba[..., 3])
    z0, disk_r, g_col, g_kind, g_freq = HARD_GROUND
    dz = dirs[..., 2]
    t_pl = (z0 - o[2]) / dz
    pt = o + dirs * t_pl[..., None]
    hit = ((dz.abs() > 1e-9) & (t_pl > 0)
           & (torch.hypot(pt[..., 0], pt[..., 1]) < disk_r) & (t_pl < tmin))
    tex = _texture(pt, g_kind, g_freq)
    for k in range(3):
        rgba[..., k] = torch.where(hit, g_col[k] * tex, rgba[..., k])
    rgba[..., 3] = torch.where(hit, 1.0, rgba[..., 3])
    return torch.clamp(rgba, 0, 1).cpu().numpy()


def save_png(path: str, image: np.ndarray) -> None:
    from PIL import Image
    Image.fromarray((image * 255).astype(np.uint8)).save(path,
                                                         compress_level=1)
