"""Ray container and fixed-size chunking on tensors.

Counterpart of mipnerf_pl_tpu/rays.py: the same `Rays` fields, with every
field a torch tensor whose leading dims are batch dims and whose trailing
dim is 3 (geometry) or 1 (scalars).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch


class Rays(NamedTuple):
    origins: Any      # [..., 3] ray origins (world)
    directions: Any   # [..., 3] un-normalized ray directions (world)
    viewdirs: Any     # [..., 3] unit-norm view directions
    radii: Any        # [..., 1] base radius of the pixel cone at t=1
    lossmult: Any     # [..., 1] per-ray loss weight (multi-scale)
    near: Any         # [..., 1] near plane
    far: Any          # [..., 1] far plane


def namedtuple_map(fn: Callable, tup):
    """Apply `fn` to each element of `tup` and cast to `tup`'s namedtuple."""
    return type(tup)(*map(fn, tup))


def rays_flatten(rays: Rays) -> Rays:
    """Flatten the leading dims of every field to [n, C]."""
    return namedtuple_map(lambda x: x.reshape(-1, x.shape[-1]), rays)


def rays_pad_to(rays: Rays, n: int) -> Rays:
    """Edge-pad flattened rays along dim 0 up to length `n` (or cut to it).

    The padding repeats the last ray, so every padded entry is a valid ray;
    callers slice the padded results away."""

    def _pad(x):
        cur = x.shape[0]
        if cur >= n:
            return x[:n]
        return torch.cat([x, x[-1:].expand(n - cur, *x.shape[1:])], dim=0)

    return namedtuple_map(_pad, rays)


def rays_chunks(rays: Rays, chunk_size: int):
    """Split rays into chunks of exactly `chunk_size` (last one edge-padded).

    Returns (list_of_chunks, n_valid)."""
    flat = rays_flatten(rays)
    n = flat.origins.shape[0]
    chunks = []
    for i in range(0, n, chunk_size):
        part = namedtuple_map(lambda x: x[i:i + chunk_size], flat)
        if part.origins.shape[0] < chunk_size:
            part = rays_pad_to(part, chunk_size)
        chunks.append(part)
    return chunks, n
