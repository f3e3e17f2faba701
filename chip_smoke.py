"""Smoke run of the PyTorch port's render and training paths on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own line; any failure raises and exits non-zero):
  1. the device, and `nvidia-smi --query-gpu=name,power.limit`;
  2. build the CUDA kernels from mipnerf_pl_tpu_torch/csrc (lean_render,
     lean_train, ipe, tp_pair) with nvcc (sm_90a), one nvcc per source, all
     started together, and time it; print each kernel's registers and
     spills, and the dynamic shared memory of the two wgmma kernels of the
     bf16 backward (lean_chain_sm90_kernel, wgrad_sm90_kernel), of the
     bf16 lean forward (lean_fwd_sm90_kernel) and of the three 3xTF32
     wgmma kernels of f32 (lean_fwd_tf32_kernel, lean_chain_tf32_kernel,
     wgrad_tf32_kernel);
  3. each render kernel's wrapper against its plain PyTorch version at the
     lego shape (8x256 MLP, N = 128, one 8192-ray chunk) on numpy-seeded
     inputs: f32 max |d| <= 1e-4, bf16 max |d| / max |ref| <= 3e-2 against
     the f32 plain version; CUDA-event times of both (and of torch.addmm,
     the one library call of view_proj's function), and for view_proj,
     whose device work is a few microseconds, the kernel's and addmm's
     device times from a torch.profiler window (the wrapper's casts of k0
     and b0 apart) at the chunk's 8192 rays and a training level's 3072;
     bf16 lean_mlp must take the wgmma forward (lean_fwd_sm90_kernel), f32
     lean_mlp the 3xTF32 one (lean_fwd_tf32_kernel) (`check_routes`);
  4. the render slice through its entry point: MipNeRFSystem (default lego
     schema, val.mlp_backend auto) -> render_camera of a 200x200 Blender
     view with seeded params (through convert.jax_params_to_torch); every
     render kernel must launch 2 levels x 5 chunks times (f32 lean_mlp on
     lean_fwd_tf32_kernel each time), the image must be
     finite, and the same frame through the plain path on the card must
     agree (max |d rgb|, max |d acc| <= 1e-3 in f32); the same frame in
     bf16, lean_mlp on the wgmma forward 2 x 5 times, against the f32 plain
     frame (max |d rgb|, max |d acc| <= 3e-2); then the frame with
     val.mlp_backend pallas (fused_mlp's forward, mlp_fwd, 2 x 5 launches)
     against the same plain frame at the same bar; then the frame with
     nerf.ipe_backend pallas (val.mlp_backend auto then resolves to the
     plain MLP: ipe_fwd alone, 2 x 5 launches) against the plain frame
     through the default encode, same bar (the two encodes' cosine halves
     differ, damped at the lego covariances);
  5. the training kernels against their plain versions at the lego level
     shape (3072 rays x 128 samples, x rows the IPE of seeded rays, seeded
     head cotangents), f32 and bf16, bars against the f32 plain version:
     lean_save_fwd and lean_fwd (outputs, saved activations, raw heads) at
     the phase-3 bars, lean_fwd bit for bit equal to lean_save_fwd's
     outputs (both, and the recompute re-runs, on the wgmma forward of
     their dtype, checked in every form; the lean chains of lean_param_grads
     and of the recompute backward on lean_chain_sm90_kernel in bf16 and
     lean_chain_tf32_kernel in f32, `check_chain_routes`; the weight
     gradients of every f32 backward on a channel-major stream, the classic
     ones and tp_pair_bwd included, on wgrad_tf32_kernel, hybrid's never,
     `check_wgrad_routes`; and the f32 weight gradients of
     lean_param_grads timed alone, their device time from a torch.profiler
     window, bound and share, beside torch.mm on the same products, the
     library's way to the same sums, in the same run, `wgrad_yardstick`);
     lean_param_grads and lean_param_grads_hybrid fed the same
     activations as their plain versions (the plain forward's, in the
     compute dtype), at bench.py's metric (largest leaf ||a - b|| / ||b||):
     <= 1e-4 f32 (hybrid too), <= 3e-2 bf16; lean_param_grads_recompute
     against lean_param_grads on the kernel forward's stream (the same
     forward re-run chunk by chunk): <= 1e-5 in both dtypes, two runs equal
     bit for bit, and its peak memory below one level-sized saved stream;
     the same three forwards and the recompute backward on the level's
     [6, M] moments (`encode=`), in f32 also against the rows form on the
     plain decode of the same moments (<= 1e-5); lean_composite_bwd (both
     backgrounds) and ipe_moments at the level's shape (<= 1e-5, f32); the
     classic kernels of fused_mlp on the level with per-point view rows (the
     view repeated over the samples, as the model feeds them): mlp_save_fwd
     (outputs and stream) and mlp_fwd (bit for bit its outputs) at the
     phase-3 bars, mlp_bwd_saved on the plain forward's stream (dx, dview
     and every parameter at bench.py's metric, <= 1e-4 f32, <= 3e-2 bf16),
     mlp_bwd_recompute against mlp_bwd_saved on the kernel forward's stream
     (<= 1e-5, dx and dview bit for bit, two runs equal); the same four
     kernels' instantiation for a model with no view layer
     (net_depth_condition 0: the rgb head reads concat(bottleneck, view)),
     the same checks at the same bars; the standalone
     IPE kernels ipe_fwd and ipe_bwd on the level's Gaussians (393,216
     points, degrees 0..16), with their covariances and with them zeroed,
     and on a ragged count: forward max |d| <= 1e-5, dmeans and dcovs
     ||a - b|| / ||b|| <= 1e-5, two runs bit-equal; the Megatron pair
     kernels tp_pair_fwd and tp_pair_bwd at the pair shapes of the level at
     net_width 1024 on a model axis of 2 (compare_pair_kernels);
     CUDA-event times of every kernel and its plain version, and each
     kernel's bound: the larger of its FLOP over the card's peak and its
     bytes over 3.35 TB/s (kernel_work);
  5b. the TP slice: tp_lean_forward on a single-process (data, model)
     mesh on the card, the lego level, net_width 1024 on 2 shards (model
     axis 2) and net_width 256 on 8 (model axis 4), bf16 and f32, forward
     and the gradient of a seeded linear loss against the full-width plain
     lean forward; tp_pair_fwd and tp_pair_bwd must launch 4 pairs x the
     shards times (8 and 8, then 32 and 32); ms of forward and of forward +
     backward and the peak memory beside the plain forward's (tp_slice);
  6. the training slice through its entry points: MipNeRFSystem (lego
     schema, 3072 synthetic rays as bench.py makes them) in each of
     TRAIN_CONFIGS (pallas_lean_save, pallas_lean, pallas_hybrid; the two
     lean backends with fuse_render + fuse_encode; pallas_lean_save with
     fuse_render on encode rows; both with fuse_encode; pallas_lean_save
     with pallas_encode; pallas and pallas_save with stop_resample_grad
     False, beside whose f32 gates the plain path's own difference between
     stop_resample_grad True and False is printed, the size of the term
     the gate must see; and nerf.ipe_backend pallas on pallas_lean_save
     (ipe_fwd 2 x 5 times) and on pallas_save with stop_resample_grad
     False (ipe_fwd 2 x 5 and ipe_bwd 1 x 5 times: only the resampled
     level's Gaussians carry a gradient), whose gate is against the plain
     path with the default encode and, printed as such, against the plain
     MLP on the same encode if the encodes' difference exceeds the bar),
     bf16 then f32: a one-step gradient-parity gate
     against the same system on the plain 'xla' backend (largest leaf
     relative error <= 3e-2 bf16, bench.py's bar; <= 2e-3 f32: the two
     forwards differ by ~1e-6, which flips the ReLU masks of pre-activations
     that close to zero, and each flip moves a whole per-point term), then
     K = 5 steps of make_train_many, in which each of the configuration's
     kernels must launch 2 levels x 5 times, every lean forward and lean
     chain on the wgmma kernel of its dtype, every f32 backward's weight
     gradients on wgrad_tf32_kernel (not hybrid's), and the loss must stay
     finite;
     ms/step, rays/s and peak memory of every configuration and of the
     plain path, in turns (plain, each configuration, then back, twice:
     best, median and spread of the 4 runs); past
     F32_TURNS_BY seconds the new configurations' f32 turns are cut, never
     a gate; one f32 gate of pallas_lean with density_noise 1.0, whose
     kernels return raw heads (act=None); and a model with no view layer
     on pallas_save with stop_resample_grad False, bf16 and f32: the gate,
     then K = 5 steps (mlp_save_fwd and mlp_bwd_saved 2 x 5 launches);
  7. the run, through the command lines a user calls: cli.train.main on an
     in-memory sphere scene (24 train / 2 val / 2 test views of 64x64, a
     Blender subclass registered here that ray-traces its views instead of
     reading files), the full-width lego model in bf16 on pallas_save with
     stop_resample_grad False and nerf.ipe_backend pallas, 3072 rays a
     step, 40 steps in dispatches of 5, validation and a checkpoint every
     20 (lr_delay_steps 0, so that 40 steps move the loss): the loss of
     step 40 is finite and below step 5's, ipe_fwd launched 2 a step and 2
     a validation frame and ipe_bwd once a step, best/ and last/ exist; a
     second call with --max_steps 50 (and --profile 1, which traces one
     dispatch with torch.profiler) resumes at 40 and ends at 50; then
     cli.eval.main on the checkpoint writes psnrs.txt / ssims.txt with
     finite values and prints the summary; the run's rays/s and the share
     of its wall time spent waiting on the batcher;
  7b. the multi-scale run through the command lines: make_sphere_scene
     writes 24 / 2 / 2 views of 200x200 (PIL) into a temporary directory,
     cli.convert --n_down 4 makes levels 200, 100, 50 and 25, cli.train
     --dataset_name multi_blender trains the full-width lego model in f32
     on pallas_lean_save, 3072 rays, 40 steps in dispatches of 5,
     validation every 20 into a recording writer: lean_save_fwd and
     lean_param_grads launch 2 a step on the f32 wgmma kernels
     (check_routes, check_chain_routes, check_wgrad_routes), the render
     kernels 2 x chunks a validation frame (lean_view_proj also 2 a step),
     nothing else; the loss of step 40 finite and below step 5's; the
     panels val/GT_coarse_fine [3, 3, h, w] and distance [3, h, w] at steps
     20 and 40; cli.eval --scale 4 --base_size 200 200 --save_image: 8
     PSNR entries, buckets 1 2 4 8 each with a non-empty .mov, a summary
     with 4 PSNR and 4 SSIM columns; then the checkpoint's 200x200, 50x50
     and 25x25 test frames through the kernel path against the plain path
     on the card (max |d rgb|, |d acc| <= 1e-3);
  7c. the orbit video: cli.render_video --scale 2 --base_size 200 200
     --n_poses 4 from that checkpoint: 4 frames and a non-empty .mov in 1/
     and in 2/, the render kernels 2 levels x chunks a frame, s/frame at
     each level;
  7d. the benches in this process: the port's bench with its defaults
     (bf16, pallas_lean_save, K = 100): the 'xla' line, then the kernel
     backend's last with parity_max_leaf_rel_err <= 3e-2, lean_save_fwd,
     lean_param_grads and lean_view_proj 2 a step (the gate's step, the
     warm-up and the timed calls); render_bench at 800x800 in f32 and bf16,
     the render kernels 2 x 79 chunks a frame;
  8. the kernels' JSON line (launches, error, times, bound, library call;
     each kernel's launches on the paths of phases 7b-7d under
     `launches_new_paths`;
     for the lean forwards and backwards also the wgmma kernel that runs
     them, f32 `kernel` / `chain` / `wgrad` and bf16 under 'bf16'; for f32
     lean_param_grads also its weight gradients' own ms, bound and
     torch.mm's ms under `wgrad_ms`),
     the script's wall time, the card's name and power limit, and last the
     line {"ok": true, "device": {...}}.

    python3 chip_smoke.py --measure

adds, before phase 8, the frame times at 800x800 (kernel and plain paths,
f32 and bf16, in turns k p p k), a torch.profiler table of one 200x200
kernel-path frame, and, with the host's issue time of an unprofiled step,
one of a bf16 train step of each lean backend, of pallas_lean_save with
fuse_render + fuse_encode and of pallas and pallas_save, and of an f32
step of the fused one and of pallas_lean_save.

It imports torch, numpy and the port; never JAX.  With no CUDA device it
exits non-zero before printing any result.
"""

import ctypes
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from mipnerf_pl_tpu_torch import bench as bench_mod
from mipnerf_pl_tpu_torch import config
from mipnerf_pl_tpu_torch import render_bench as render_bench_mod
from mipnerf_pl_tpu_torch import system as system_mod
from mipnerf_pl_tpu_torch.cli import convert as convert_cli
from mipnerf_pl_tpu_torch.cli import eval as eval_cli
from mipnerf_pl_tpu_torch.cli import render_video as video_cli
from mipnerf_pl_tpu_torch.cli import train as train_cli
from mipnerf_pl_tpu_torch.convert import jax_params_to_torch
from mipnerf_pl_tpu_torch.data.datasets import (Blender, _alpha_composite,
                                                dataset_dict)
from mipnerf_pl_tpu_torch.data.synthetic import (CAMERA_ANGLE_X,
                                                 make_sphere_scene,
                                                 render_sphere_view)
from mipnerf_pl_tpu_torch.kernels import _build
from mipnerf_pl_tpu_torch.kernels import ipe as ki
from mipnerf_pl_tpu_torch.kernels import mlp as km
from mipnerf_pl_tpu_torch.kernels import tp_lean as kt
from mipnerf_pl_tpu_torch.models.mlp import LEAN_BACKENDS
from mipnerf_pl_tpu_torch.ops.camera import Camera, pix2cam_from_focal
from mipnerf_pl_tpu_torch.ops.math import (cast_rays_cmajor,
                                           integrated_pos_enc, pos_enc)
from mipnerf_pl_tpu_torch.ops.render import delta_mids
from mipnerf_pl_tpu_torch.ops.sampling import sample_along_rays
from mipnerf_pl_tpu_torch.parallel.mesh import create_mesh
from mipnerf_pl_tpu_torch.rays import Rays
from mipnerf_pl_tpu_torch.system import MipNeRFSystem, make_dataset
from mipnerf_pl_tpu_torch.train.ckpt import load_hparams, restore_for_eval
from mipnerf_pl_tpu_torch.utils.vis import create_spheric_poses

CHUNK = 8192            # rays per level-chunk (val.chunk_size)
SIDE = 200              # frame side: 40000 rays = 5 chunks
FULL_SIDE = 800         # the lego test views' size (--measure)
TRAIN_RAYS = 3072       # train.batch_size of the lego schema
TRAIN_K = 5             # steps per make_train_many call
TURN_ROUNDS = 2         # timing: the configurations in turns, there and back
RENDER_KERNELS = ('lean_view_proj', 'lean_mlp', 'lean_composite')
_SAVE = ('lean_save_fwd', 'lean_param_grads')
_RECOMPUTE = ('lean_fwd', 'lean_param_grads_recompute')
_COMPOSITE = ('lean_composite', 'lean_composite_bwd')
_RESAMPLE = {'nerf.stop_resample_grad': False}
_RENDER_ENCODE = {'nerf.fuse_render': True, 'nerf.fuse_encode': True}
_IPE = {'nerf.ipe_backend': 'pallas'}
# Each training configuration -> (nerf.mlp_backend, the fusion options, the
# kernels its step must launch per level).
TRAIN_CONFIGS = {
    'pallas_lean_save': ('pallas_lean_save', {}, _SAVE),
    'pallas_lean': ('pallas_lean', {}, _RECOMPUTE),
    'pallas_hybrid': ('pallas_hybrid', {}, ('lean_param_grads_hybrid',)),
    'pallas_lean_save+render+encode': ('pallas_lean_save', _RENDER_ENCODE,
                                       _SAVE + _COMPOSITE),
    'pallas_lean+render+encode': ('pallas_lean', _RENDER_ENCODE,
                                  _RECOMPUTE + _COMPOSITE),
    'pallas_lean_save+render': ('pallas_lean_save',
                                {'nerf.fuse_render': True},
                                _SAVE + _COMPOSITE),
    'pallas_lean_save+encode': ('pallas_lean_save',
                                {'nerf.fuse_encode': True}, _SAVE),
    'pallas_lean+encode': ('pallas_lean', {'nerf.fuse_encode': True},
                           _RECOMPUTE),
    'pallas_lean_save+pallas_encode': ('pallas_lean_save',
                                       {'nerf.pallas_encode': True},
                                       _SAVE + ('ipe_moments',)),
    'pallas+resample': ('pallas', _RESAMPLE, ('mlp_fwd', 'mlp_bwd_recompute')),
    'pallas_save+resample': ('pallas_save', _RESAMPLE,
                             ('mlp_save_fwd', 'mlp_bwd_saved')),
    'pallas_lean_save+ipe': ('pallas_lean_save', _IPE, _SAVE + ('ipe_fwd',)),
    'pallas_save+resample+ipe': ('pallas_save', {**_RESAMPLE, **_IPE},
                                 ('mlp_save_fwd', 'mlp_bwd_saved', 'ipe_fwd',
                                  'ipe_bwd')),
}
# Launches a step of the kernels that do not run once a level: only the
# resampled level's Gaussians carry a gradient into ipe_bwd.
PER_STEP = {'ipe_bwd': 1}
# The configurations that train with the resample gradient (fused_mlp).
CLASSIC_CONFIGS = ('pallas+resample', 'pallas_save+resample',
                   'pallas_save+resample+ipe')
# The configurations whose f32 timing turns are cut first if the run must
# be shortened (the gates never are).
NEW_CONFIGS = tuple(list(TRAIN_CONFIGS)[3:])
# --measure profiles a bf16 step of each lean backend, of this one and of
# CLASSIC_CONFIGS.
PROFILED_CONFIG = 'pallas_lean_save+render+encode'
# Past this many seconds from the start, phase 6 cuts the f32 timing turns
# of NEW_CONFIGS (half the 1200 s a run may take, less the f32 turns).
F32_TURNS_BY = 420
START = time.perf_counter()
RECOMPUTE_BAR = 1e-5    # recompute vs save: only the f32 bias sums' order
F32_BAR = 1e-4
BF16_BAR = 3e-2
F32_GATE_BAR = 2e-3     # see phase 6 in the docstring
FRAME_BAR = 1e-3
FORM_BAR = 1e-5         # moments vs rows form, composite backward, encode
# The run of phase 7: views and steps.
RUN_VIEWS = {'train': 24, 'val': 2, 'test': 2}
RUN_SIDE = 64
RUN_STEPS, RUN_RESUMED_STEPS, RUN_K, RUN_VAL = 40, 50, 5, 20
ACT = (0.001, -1.0)
# The multi-scale run of phase 7b: views of MS_SIDE on disk, MS_LEVELS
# pyramid levels, and the test entries (view 0's levels 200, 50, 25) held
# against the plain path; the orbit video of phase 7c.
MS_VIEWS = {'n_train': 24, 'n_val': 2, 'n_test': 2}
MS_SIDE, MS_LEVELS = 200, 4
MS_FRAMES = (0, 2, 3)
VIDEO_SCALES, VIDEO_POSES = 2, 4
# The TP slice: (net_width, shards, model axis) of its two meshes, and the
# rows of the ragged pair comparison.
TP_MESHES = ((1024, 2, 2), (256, 8, 4))
TP_RAGGED_ROWS = 100003
_NO_VIEW = {'nerf.mlp.net_depth_condition': 0}
# The card's published rates (NVIDIA H100 SXM data sheet, 700 W): HBM
# bytes/s; tensor-core FLOP/s in bf16 and for f32 as 3xTF32 (the route the
# f32 kernels take: three TF32 products, 495 / 3); CUDA-core f32 FLOP/s.
HBM_RATE = 3.35e12
TC_RATE = {'bf16': 989e12, 'f32': 495e12 / 3}
CUDA_CORE_RATE = 67e12


def log(msg):
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f'nvidia-smi failed: {out.stderr.strip()}')
    return out.stdout.strip().splitlines()[0]


def kernel_resources(ptxas_log: str):
    """[(kernel, spill line, registers line)] from nvcc -Xptxas -v output,
    the names demangled by c++filt where the machine has it."""
    import re
    rows = re.findall(r"Function properties for (\S+)\n\s*(.*spill.*)\n"
                      r".*?(Used \d+ registers[^\n]*)", ptxas_log)
    names = [r[0] for r in rows]
    try:
        out = subprocess.run(['c++filt'], input='\n'.join(names),
                             capture_output=True, text=True, timeout=60)
        if out.returncode == 0 and len(out.stdout.splitlines()) == len(names):
            names = [n.replace('(anonymous namespace)::', '')
                     for n in out.stdout.splitlines()]
    except OSError:
        pass
    return [(n, r[1].strip(), r[2].strip()) for n, r in zip(names, rows)]


def cuda_ms(fn, iters: int = 5) -> float:
    """Mean device time of fn() over `iters` runs after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def lego_cg(hp) -> int:
    """Rows of the backward's cotangent stream G (every layer's outputs)."""
    W, Wv = hp['nerf.mlp.net_width'], hp['nerf.mlp.net_width_condition']
    dcond = hp['nerf.mlp.net_depth_condition']
    return hp['nerf.mlp.net_depth'] * W + 1 + W + dcond * Wv + 3


def kernel_device_ms(fn, iters: int = 20) -> dict:
    """{device kernel name: ms per call} of fn() from a torch.profiler
    window of `iters` calls after a warm-up: the kernels' own durations,
    which the host's issue time does not enter."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / iters
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}


def layer_shapes(hp):
    """The (in, out) of hp's MLP kernels in param order."""
    depth = hp['nerf.mlp.net_depth']
    dcond = hp['nerf.mlp.net_depth_condition']
    skip = hp['nerf.mlp.skip_index']
    W = hp['nerf.mlp.net_width']
    Wv = hp['nerf.mlp.net_width_condition']
    F = 6 * (hp['nerf.max_deg_point'] - hp['nerf.min_deg_point'])
    Fv = 3 * (2 * hp['nerf.deg_view'] + 1)
    shapes, d_in = [], F
    for i in range(depth):
        shapes.append((d_in, W))
        d_in = W + (F if i % skip == 0 and i > 0 else 0)
    shapes += [(d_in, 1), (d_in, W)]
    if dcond:
        shapes += [(W + Fv, Wv)] + [(Wv, Wv)] * (dcond - 1) + [(Wv, 3)]
    else:               # no view layer: the rgb head reads [bottleneck, view]
        shapes += [(W + Fv, 3)]
    return shapes


def kernel_work(name, hp, R, N, tag, form='rows'):
    """(tensor-core FLOP, CUDA-core operations, bytes) of one call of
    kernel `name` at R rays x N samples in the compute dtype `tag` ('f32'
    or 'bf16'), from the lego schema's widths: every input read once and
    every output written once.  form='moments': the training forward reads
    the [6, M] moments and decodes them.  Elementwise work is counted at a
    few operations a value: 8 an encode feature (the decode), 12 a point
    (the composite), 30 a point (its backward)."""
    depth = hp['nerf.mlp.net_depth']
    dcond = hp['nerf.mlp.net_depth_condition']
    W = hp['nerf.mlp.net_width']
    Wv = hp['nerf.mlp.net_width_condition']
    F = 6 * (hp['nerf.max_deg_point'] - hp['nerf.min_deg_point'])
    Fv = 3 * (2 * hp['nerf.deg_view'] + 1)
    M, Mp = R * N, -(-R * N // km.TILE) * km.TILE
    es = 2 if tag == 'bf16' else 4
    Fp, _, _, _, Cs = km.saved_rows(F, W, Wv, depth, dcond)
    shapes = layer_shapes(hp)
    n_w = sum(k * n for k, n in shapes)
    n_b = sum(n for _, n in shapes)
    params = n_w * es + n_b * 4
    grads = (n_w + n_b) * 4
    fwd = 2 * M * (n_w - Fv * Wv)          # view_0's per-ray rows: view_proj
    chain = W * (W * (depth - 1) + 1 + W) + W * Wv \
        + sum(k * n for k, n in shapes[depth + 3:])
    bwd = 2 * M * chain + fwd + 2 * R * Fv * Wv
    x_in, decode = (M * F * 4, 0) if form == 'rows' else (M * 24, 8 * M * F)
    g, view, vproj = M * 16, R * Fv * 4, R * Wv * 4
    if name == 'lean_view_proj':
        return 0, 2 * R * Fv * Wv, view + Fv * Wv * es + Wv * 4 + vproj
    if name == 'lean_mlp':
        return fwd, 8 * M * F, M * 24 + vproj + params + M * 16
    if name == 'lean_composite':
        return 0, 12 * M, M * 28 + R * 32
    if name == 'lean_composite_bwd':
        return 0, 30 * M, M * 44 + R * 32
    if name == 'ipe_moments':
        return 0, 8 * M * F, M * (24 + 4 * F)
    # The standalone IPE: an expf and a sincosf a feature pair forward; the
    # same and the two products and sums of the VJP backward.
    if name == 'ipe_fwd':
        return 0, 8 * M * F, M * (24 + 4 * F)
    if name == 'ipe_bwd':
        return 0, 12 * M * F, M * (24 + 4 * F + 24)
    if name == 'lean_fwd':
        return fwd, decode, x_in + vproj + params + M * 16
    if name == 'lean_save_fwd':
        return fwd, decode, x_in + vproj + params + M * 16 + Cs * Mp * es \
            + Mp * 16
    if name == 'lean_param_grads':
        return bwd, 0, Cs * Mp * es + Mp * 16 + g + view + params + grads
    if name == 'lean_param_grads_recompute':
        return fwd + bwd, decode, x_in + vproj + g + view + params + grads
    if name == 'lean_param_grads_hybrid':
        res = M * (Fp + (depth + 1) * W + dcond * Wv) * es
        return bwd, 0, res + g + view + params + grads
    # The classic MLP of fused_mlp, as the JAX function's inputs and
    # outputs: x and the view f32 per point (view_0 on all of them), raw
    # heads; the backward's chain runs back to the inputs (every layer's
    # input cotangent, as many products as the forward) beside every weight
    # gradient, dx and dview out; the saved stream is the JAX set (hs,
    # bottleneck, ys) in the compute dtype.
    cfwd = 2 * M * n_w
    pts = M * (F + Fv) * 4
    stream = M * ((depth + 1) * W + dcond * Wv) * es
    if name == 'mlp_fwd':
        return cfwd, 0, pts + params + g
    if name == 'mlp_save_fwd':
        return cfwd, 0, pts + params + g + stream
    if name == 'mlp_bwd_saved':
        return 2 * cfwd, 0, stream + 2 * pts + g + params + grads
    if name == 'mlp_bwd_recompute':
        return 3 * cfwd, 0, 2 * pts + g + params + grads
    raise KeyError(name)


def pair_work(name, M, f_in, Wl, Wout, tag, x_f32):
    """kernel_work of one Megatron pair call: forward 2 M Wl (f_in + Wout)
    FLOP, backward 2 M Wl (3 f_in + 2 Wout) (the recompute, dWrow, dh,
    dWcol, dx); the bytes of x, the two panels and the bias and the f32
    partial, and backward also of g and the f32 dx and parameter
    gradients."""
    es = 2 if tag == 'bf16' else 4
    x_in = M * f_in * (4 if x_f32 else es)
    panels = (f_in * Wl + Wl * Wout) * es + Wl * 4
    if name == 'tp_pair_fwd':
        return 2 * M * Wl * (f_in + Wout), 0, x_in + panels + M * Wout * 4
    if name == 'tp_pair_bwd':
        return (2 * M * Wl * (3 * f_in + 2 * Wout), 0,
                x_in + panels + M * Wout * 4 + M * f_in * 4
                + (f_in * Wl + Wl * Wout + Wl) * 4)
    raise KeyError(name)


def bound(name, hp, R, N, tag, form='rows', work=None):
    """(bound_ms, 'bytes' or 'operations'): the least time the card could
    take for kernel_work (or the `work` given) at the published rates."""
    tc, cc, nbytes = work or kernel_work(name, hp, R, N, tag, form)
    ops_s = tc / TC_RATE[tag] + cc / CUDA_CORE_RATE
    bytes_s = nbytes / HBM_RATE
    return (max(ops_s, bytes_s) * 1e3,
            'operations' if ops_s >= bytes_s else 'bytes')


def record(results, key, hp, R, N, err, ms, plain_ms, library_ms=None,
           form='rows', work=None):
    """Keep one kernel's numbers under key = (name, tag) with its bound."""
    name, tag = key
    b_ms, b_by = bound(name.split('[')[0], hp, R, N, tag, form, work)
    results[key] = dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                        bound_by=b_by, library_ms=library_ms)
    log(f'[bound] {name} {tag}: {b_ms:.4f} ms ({b_by}), kernel at '
        f'{100 * b_ms / ms:.1f} % of it')


def _widths(hp):
    F = 6 * (hp['nerf.max_deg_point'] - hp['nerf.min_deg_point'])
    return (F, hp['nerf.mlp.net_width'], hp['nerf.mlp.net_width_condition'],
            hp['nerf.mlp.net_depth'], hp['nerf.mlp.net_depth_condition'])


def sm90_route(hp, dt) -> bool:
    """Whether the lean forwards of hp's MLP in dt take the bf16 wgmma
    forward (lean_fwd_sm90_kernel): kernels/mlp.py fwd_sm90_route."""
    return km.fwd_sm90_route(dt, *_widths(hp))


def tf32_route(hp, dt) -> bool:
    """Whether they take the f32 wgmma forward (lean_fwd_tf32_kernel):
    kernels/mlp.py fwd_tf32_route."""
    return km.fwd_tf32_route(dt, *_widths(hp))


def chain_route(hp, dt):
    """(bf16 lean_chain_sm90_kernel, f32 lean_chain_tf32_kernel): whether
    the lean chain of hp's MLP in dt takes each."""
    w = _widths(hp)[1:]
    return km.chain_sm90_route(dt, *w), km.chain_tf32_route(dt, *w)


def check_routes(hp, dt, where, **calls):
    """Raise unless each named wrapper's `calls` since the last
    reset_launches ran on lean_fwd_sm90_kernel where fwd_sm90_route says so,
    on lean_fwd_tf32_kernel where fwd_tf32_route says so, and on the
    mma.sync tile elsewhere; the lego schema's forwards must take the
    wgmma forward of their dtype."""
    on = sm90_route(hp, dt), tf32_route(hp, dt)
    if hp['nerf.mlp.net_width'] == 256 and not any(on):
        raise AssertionError(f'the lego {dt} forwards take no wgmma forward')
    got = {k: (km.routes[k], km.tf32_routes[k]) for k in calls}
    want = {k: (n if on[0] else 0, n if on[1] else 0)
            for k, n in calls.items()}
    log(f'[route] {where}: calls on (lean_fwd_sm90_kernel, '
        f'lean_fwd_tf32_kernel) {got} (want {want}) '
        f'{"OK" if got == want else "FAIL"}')
    if got != want:
        raise AssertionError(f'{where}: the forwards took another route')


def check_chain_routes(hp, dt, where, **calls):
    """Raise unless each named backward's `calls` since the last
    reset_launches ran their lean chain on lean_chain_sm90_kernel (bf16) or
    lean_chain_tf32_kernel (f32) where chain_sm90_route / chain_tf32_route
    say so; the lego schema's chains must take the one of their dtype."""
    on = chain_route(hp, dt)
    if hp['nerf.mlp.net_width'] == 256 and not any(on):
        raise AssertionError(f'the lego {dt} chain takes no wgmma kernel')
    got = {k: (km.chain_routes[k], km.chain_tf32_routes[k]) for k in calls}
    want = {k: (n if on[0] else 0, n if on[1] else 0)
            for k, n in calls.items()}
    log(f'[route] {where}: chains on (lean_chain_sm90_kernel, '
        f'lean_chain_tf32_kernel) {got} (want {want}) '
        f'{"OK" if got == want else "FAIL"}')
    if got != want:
        raise AssertionError(f'{where}: the chain took another route')


def lego_wgrad_range(hp):
    """(Mp, MC) of the lean backward at a training level of hp: its padded
    points and the points of one weight-gradient range (wgrad_split over
    its output tiles on this card)."""
    N = hp['nerf.num_samples']
    Mp = -(-TRAIN_RAYS * N // km.TILE) * km.TILE
    depth = hp['nerf.mlp.net_depth']
    dcond = hp['nerf.mlp.net_depth_condition']
    tiles = km.wgrad_problems(layer_shapes(hp), depth, dcond,
                              hp['nerf.mlp.skip_index'])[1]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return Mp, km.wgrad_split(Mp, len(tiles), N, sms)


def check_wgrad_routes(hp, dt, where, **calls):
    """Raise unless each named backward's `calls` since the last
    reset_launches ran their weight gradients on wgrad_tf32_kernel where
    wgrad_tf32_route says so (f32 on a channel-major stream: every entry
    but hybrid) and never elsewhere; at the lego level an f32 channel-major
    backward must take it."""
    Mp, mc = lego_wgrad_range(hp)
    hybrid = 'lean_param_grads_hybrid'
    on = {k: km.wgrad_tf32_route(dt, k == hybrid, Mp, mc) for k in calls}
    if dt == torch.float32 and any(k != hybrid and not on[k] for k in calls):
        raise AssertionError('the lego f32 weight gradients take no wgmma '
                             'kernel')
    got = {k: km.wgrad_tf32_routes[k] for k in calls}
    want = {k: n if on[k] else 0 for k, n in calls.items()}
    log(f'[route] {where}: weight gradients on wgrad_tf32_kernel {got} '
        f'(want {want}) {"OK" if got == want else "FAIL"}')
    if got != want:
        raise AssertionError(f'{where}: the weight gradients took another '
                             'route')


def flax_tree(system: MipNeRFSystem, seed: int) -> dict:
    """Numpy-seeded flax-layout params (Xavier-uniform kernels [in, out],
    zero biases) for the system's MLP, as the JAX package initializes."""
    rng = np.random.default_rng(seed)
    mlp = {}
    for key, value in system.eval_model.state_dict().items():
        _, name, kind = key.split('.')
        if kind == 'weight':
            fan_out, fan_in = value.shape
            lim = np.sqrt(6.0 / (fan_in + fan_out))
            mlp.setdefault(name, {})['kernel'] = rng.uniform(
                -lim, lim, size=(fan_in, fan_out)).astype(np.float32)
        else:
            mlp.setdefault(name, {})['bias'] = np.zeros(value.shape,
                                                        np.float32)
    return {'params': {'mlp': mlp}}


def chunk_inputs(hp, dev, seed=0):
    """One level-chunk of the main path from numpy-seeded rays around the
    radius-4 orbit: moments [6, M], view [R, 27], delta/mids [R, N]."""
    rng = np.random.default_rng(seed)
    R, N = CHUNK, hp['nerf.num_samples']
    origins = rng.normal(size=(R, 3)) * 0.1 + np.array([0.0, 3.2, 2.35])
    target = rng.uniform(-1.0, 1.0, size=(R, 3))
    dirs = target - origins
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)  # noqa
    o, d = t(origins), t(dirs)
    radii = t(np.full((R, 1), 5e-4))
    near, far = t(np.full((R, 1), 2.0)), t(np.full((R, 1), 6.0))
    t_samples, _ = sample_along_rays(o, d, radii, N, near, far, False, False,
                                     'cone')
    moments = cast_rays_cmajor(t_samples, o, d, radii).reshape(6, -1)
    view = pos_enc(d, 0, hp['nerf.deg_view'])
    delta, mids = delta_mids(t_samples, d)
    return moments.contiguous(), view, delta, mids


def compare_kernels(params, hp, dev):
    """Phase 3: each wrapper against its plain version, f32 and bf16."""
    N = hp['nerf.num_samples']
    depth = hp['nerf.mlp.net_depth']
    dcond = hp['nerf.mlp.net_depth_condition']
    skip = hp['nerf.mlp.skip_index']
    W = hp['nerf.mlp.net_width']
    enc = (hp['nerf.min_deg_point'], hp['nerf.max_deg_point'])
    flat = flat_params(params, hp)
    moments, view, delta, mids = chunk_inputs(hp, dev)
    iv = 2 * (depth + 2)
    # f32 plain references; bf16 kernels are held against these too.
    ref_vp = km.view_proj_plain(view, flat[iv], flat[iv + 1], W,
                                torch.float32)
    ref_rs = km.lean_mlp_plain(moments, ref_vp, flat, N, depth, dcond, skip,
                               torch.float32, ACT, enc)
    ref_pr, ref_w = km.lean_composite_plain(ref_rs, delta, mids, True)
    results = {}
    for dt in (torch.float32, torch.bfloat16):
        calls = {
            'lean_view_proj': (
                lambda: km.view_proj(view, flat[iv], flat[iv + 1], W, dt),
                lambda: km.view_proj_plain(view, flat[iv], flat[iv + 1], W,
                                           dt),
                [ref_vp]),
            'lean_mlp': (
                lambda: km.lean_mlp(moments, ref_vp, flat, N, depth, dcond,
                                    skip, dt, ACT, enc),
                lambda: km.lean_mlp_plain(moments, ref_vp, flat, N, depth,
                                          dcond, skip, dt, ACT, enc),
                [ref_rs]),
            'lean_composite': (
                lambda: km.lean_composite(ref_rs, delta, mids, True),
                lambda: km.lean_composite_plain(ref_rs, delta, mids, True),
                [ref_pr, ref_w]),
        }
        for name, (kernel, plain, refs) in calls.items():
            if name == 'lean_composite' and dt != torch.float32:
                continue              # the composite is f32 in both modes
            km.reset_launches()
            got = kernel()
            torch.cuda.synchronize()
            if name == 'lean_mlp':
                check_routes(hp, dt, f'phase 3 lean_mlp {dt}', lean_mlp=1)
            got = got if isinstance(got, tuple) else (got,)
            err = max(float((g - r).abs().max()) for g, r in zip(got, refs))
            scale = max(float(r.abs().max()) for r in refs)
            finite = all(bool(torch.isfinite(g).all()) for g in got)
            ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
            tag = 'f32' if dt == torch.float32 else 'bf16'
            if dt == torch.float32:
                ok = finite and err <= F32_BAR
                bar = f'max|d| <= {F32_BAR}'
            else:
                ok = finite and err / scale <= BF16_BAR
                bar = f'max|d|/max|ref| = {err / scale:.3e} <= {BF16_BAR}'
            log(f'[kernel] {name} {tag}: max|d| {err:.3e} ({bar}) '
                f'kernel {ms:.3f} ms  plain {plain_ms:.3f} ms  '
                f'{"OK" if ok else "FAIL"}')
            if not ok:
                raise AssertionError(f'{name} {tag} disagrees with its plain '
                                     f'version: max|d| {err:.3e}')
            library_ms = None
            if name == 'lean_view_proj':
                # The one PyTorch call of the same function (a yardstick,
                # never called by the port): addmm in the compute dtype.
                # Both are a few microseconds of device work, so the
                # events above read the host's issue time: the profiler's
                # kernel durations give the device time, the wrapper's
                # cast of k0 and rounding of b0 apart.
                # Device times at the chunk's rays and at a training
                # level's (the rays a block follow R).
                kv, bv, vv = (t.to(dt) for t in (flat[iv][W:], flat[iv + 1],
                                                 view))
                library_ms = cuda_ms(lambda: torch.addmm(bv, vv, kv))
                for rays in (CHUNK, TRAIN_RAYS):
                    vw, vb = view[:rays], vv[:rays]
                    own = kernel_device_ms(lambda: km.view_proj(
                        vw, flat[iv], flat[iv + 1], W, dt))
                    lib = kernel_device_ms(lambda: torch.addmm(bv, vb, kv))
                    vp_dev = sum(v for k, v in own.items()
                                 if 'view_proj' in k)
                    lib_dev = sum(lib.values())
                    log(f'[kernel] {name} {tag} at {rays} rays: device time '
                        f'(torch.profiler): kernel {vp_dev * 1e3:.2f} us + '
                        f'wrapper casts '
                        f'{(sum(own.values()) - vp_dev) * 1e3:.2f} us, '
                        f'torch.addmm {lib_dev * 1e3:.2f} us '
                        f'({", ".join(sorted(lib))}): kernel '
                        f'{"no slower" if vp_dev <= lib_dev else "SLOWER"}')
                log(f'[kernel] {name} {tag}: torch.addmm {library_ms:.3f} ms '
                    f'(events)')
            record(results, (name, tag), hp, CHUNK, N, err, ms, plain_ms,
                   library_ms)
    return results


def flat_params(params, hp):
    """The converted params in param order, [in, out] kernels, as the main
    path hands them to the kernels."""
    flat = []
    for name in km.param_order(hp['nerf.mlp.net_depth'],
                               hp['nerf.mlp.net_depth_condition']):
        flat.append(params[f'mlp.{name}.weight'].t())
        flat.append(params[f'mlp.{name}.bias'].reshape(1, -1))
    return flat


def train_batch(B, dev, seed=0):
    """bench.py's synthetic rays: normalised random directions, origins near
    the centre, radius 0.005, near 2, far 6; uniform pixel targets."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(B, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ones = np.ones((B, 1), np.float32)
    o = rng.normal(size=(B, 3)).astype(np.float32) * 0.1
    fields = (o, d, d, ones * 0.005, ones, ones * 2.0, ones * 6.0)
    pixels = rng.uniform(size=(B, 3)).astype(np.float32)
    return (Rays(*(torch.tensor(f, device=dev) for f in fields)),
            torch.tensor(pixels, device=dev))


def level_inputs(hp, dev, seed=1):
    """One training level of the main path: x rows = the IPE of the
    stratified samples of TRAIN_RAYS seeded rays [M, 96], view [R, 27],
    seeded head cotangents [M, 3] / [M, 1]; and the same samples' moments
    [6, M], delta / mids [R, N]."""
    rays, _ = train_batch(TRAIN_RAYS, dev, seed)
    t_samples, means_covs = sample_along_rays(
        rays.origins, rays.directions, rays.radii, hp['nerf.num_samples'],
        rays.near, rays.far, False, False, 'cone')
    x = integrated_pos_enc(means_covs, hp['nerf.min_deg_point'],
                           hp['nerf.max_deg_point'])
    x = x.reshape(-1, x.shape[-1]).contiguous()
    view = pos_enc(rays.viewdirs, 0, hp['nerf.deg_view'])
    rng = np.random.default_rng(seed + 1)
    M = x.shape[0]
    g = [torch.tensor(rng.normal(size=(M, c)).astype(np.float32), device=dev)
         for c in (3, 1)]
    moments = cast_rays_cmajor(t_samples, rays.origins, rays.directions,
                               rays.radii).reshape(6, -1).contiguous()
    delta, mids = delta_mids(t_samples, rays.directions)
    return x, view, g[0], g[1], moments, delta, mids


def fwd_err(got, ref, dt):
    """(max |d|, bar text, ok) of a forward's outputs at the phase-3
    bars."""
    err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
    if dt == torch.float32:
        return err, f'max|d| <= {F32_BAR}', err <= F32_BAR
    rel = max(float((a - b).abs().max()) / float(b.abs().max())
              for a, b in zip(got, ref))
    return err, f'max|d|/max|ref| = {rel:.3e} <= {BF16_BAR}', \
        rel <= BF16_BAR


def reporter(results, hp):
    """Phase 5's report(name, tag, ok, text, err, ms, plain_ms, form): log
    one kernel's check and times, raise if it failed, and record its
    numbers with its bound at the training level's shape."""
    def report(name, tag, ok, text, err, ms, plain_ms, form='rows',
               work=None):
        log(f'[kernel] {name} {tag}: {text}; kernel {ms:.3f} ms  plain '
            f'{plain_ms:.3f} ms  {"OK" if ok else "FAIL"}')
        if not ok:
            raise AssertionError(f'{name} {tag} disagrees with its plain '
                                 'version')
        record(results, (name, tag), hp, TRAIN_RAYS, hp['nerf.num_samples'],
               err, ms, plain_ms, form=form, work=work)
    return report


def fwd_parts(out, M):
    """A training forward's outputs, saved stream and raw heads of its M
    points, f32."""
    rgb, dens, (S, heads) = out
    return [rgb, dens, S[:, :M].float(), heads[:, :M]]


def leaf_rel_err(got, want, names=None):
    """bench.py's metric: the largest ||a - b|| / ||b|| over the leaves;
    with `names`, (that error, the name of its leaf)."""
    errs = [float(torch.linalg.norm(a.double() - b.double())
                  / (torch.linalg.norm(b.double()) + 1e-12))
            for a, b in zip(got, want)]
    worst = max(range(len(errs)), key=errs.__getitem__)
    return errs[worst] if names is None else (errs[worst], names[worst])


def leaf_names(hp):
    return [f'{n}.{k}' for n in km.param_order(
        hp['nerf.mlp.net_depth'], hp['nerf.mlp.net_depth_condition'])
        for k in ('kernel', 'bias')]


def compare_train_kernels(params, hp, dev):
    """Phase 5: the training kernels against their plain versions at the
    lego level shape, f32 and bf16."""
    args = (hp['nerf.num_samples'], hp['nerf.mlp.net_depth'],
            hp['nerf.mlp.net_depth_condition'], hp['nerf.mlp.skip_index'])
    flat = flat_params(params, hp)
    x, view, g_rgb, g_dens, moments, delta, mids = level_inputs(hp, dev)
    M = x.shape[0]
    enc = (hp['nerf.min_deg_point'], hp['nerf.max_deg_point'])

    def plain_fwd(dt):
        return km.lean_mlp_save_plain(x, view, flat, *args, dt, ACT)

    def plain_bwd(dt, saved):
        return km.lean_param_grads_plain(view, g_rgb, g_dens, saved, flat,
                                         *args, dt, ACT)

    def recompute(dt):
        return km.lean_param_grads_recompute(x, view, g_rgb, g_dens, flat,
                                             *args, dt, ACT)

    def hybrid(dt, res, kernel=True):
        fn = (km.lean_param_grads_hybrid if kernel
              else km.lean_param_grads_hybrid_plain)
        return fn(view, g_rgb, g_dens, res, flat, *args, dt, ACT)

    results = {}
    report = reporter(results, hp)
    ref = plain_fwd(torch.float32)
    ref_parts = fwd_parts(ref, M)
    ref_out = km.lean_fwd_plain(x, view, flat, *args, torch.float32, ACT)
    for dt in (torch.float32, torch.bfloat16):
        tag = 'f32' if dt == torch.float32 else 'bf16'
        g_bar = F32_BAR if dt == torch.float32 else BF16_BAR

        # Forwards: lean_save_fwd, and lean_fwd, which must give its bits.
        km.reset_launches()
        out = km.lean_save_fwd(x, view, flat, *args, dt, ACT)
        lf = km.lean_fwd(x, view, flat, *args, dt, ACT)
        torch.cuda.synchronize()
        check_routes(hp, dt, f'phase 5 forwards {tag}', lean_save_fwd=1,
                     lean_fwd=1)
        parts = fwd_parts(out, M)
        finite = all(bool(torch.isfinite(t).all()) for t in parts)
        f_err, f_bar, f_ok = fwd_err(parts, ref_parts, dt)
        report('lean_save_fwd', tag, finite and f_ok,
               f'max|d| {f_err:.3e} ({f_bar})', f_err,
               cuda_ms(lambda: km.lean_save_fwd(x, view, flat, *args, dt,
                                                ACT)),
               cuda_ms(lambda: plain_fwd(dt)))
        same = all(torch.equal(a, b) for a, b in zip(lf, out[:2]))
        l_err, l_bar, l_ok = fwd_err(lf, ref_out, dt)
        report('lean_fwd', tag, same and l_ok,
               f'max|d| {l_err:.3e} ({l_bar}); bit-equal to lean_save_fwd '
               f'{same}', l_err,
               cuda_ms(lambda: km.lean_fwd(x, view, flat, *args, dt, ACT)),
               cuda_ms(lambda: km.lean_fwd_plain(x, view, flat, *args, dt,
                                                 ACT)))
        del lf

        # The save backward on the plain forward's stream: the kernel
        # forward's own stream differs by its ~1e-6 (f32), which flips the
        # ReLU masks of pre-activations that close to zero.
        saved = ref[2] if dt == torch.float32 else plain_fwd(dt)[2]
        km.reset_launches()
        grads = km.lean_param_grads(view, g_rgb, g_dens, saved, flat, *args,
                                    dt, ACT)
        ref_grads = plain_bwd(torch.float32, saved)
        torch.cuda.synchronize()
        check_chain_routes(hp, dt, f'phase 5 lean_param_grads {tag}',
                           lean_param_grads=1)
        check_wgrad_routes(hp, dt, f'phase 5 lean_param_grads {tag}',
                           lean_param_grads=1)
        finite = all(bool(torch.isfinite(t).all()) for t in grads)
        g_abs = max(float((a - b).abs().max())
                    for a, b in zip(grads, ref_grads))
        g_err, g_leaf = leaf_rel_err(grads, ref_grads, leaf_names(hp))
        extra = ''
        if dt == torch.float32:
            own = km.lean_param_grads(view, g_rgb, g_dens, out[2], flat,
                                      *args, dt, ACT)
            extra = (f'; fed its own forward\'s stream '
                     f'{leaf_rel_err(own, ref_grads):.3e}')
            del own
        report('lean_param_grads', tag, finite and g_err <= g_bar,
               f'max leaf rel err vs the f32 plain backward {g_err:.3e} '
               f'({g_leaf}, <= {g_bar}){extra}; max|d| {g_abs:.3e}', g_abs,
               cuda_ms(lambda: km.lean_param_grads(
                   view, g_rgb, g_dens, saved, flat, *args, dt, ACT)),
               cuda_ms(lambda: plain_bwd(dt, saved)))
        if dt == torch.float32:
            results[('lean_param_grads', tag)]['wgrad'] = wgrad_yardstick(
                hp, flat, args, saved, lambda: km.lean_param_grads(
                    view, g_rgb, g_dens, saved, flat, *args, dt, ACT))
        del grads, saved, ref_grads

        # Recompute: against the save backward on the kernel forward's
        # stream (the forward it re-runs), twice, and its peak memory.
        want = km.lean_param_grads(view, g_rgb, g_dens, out[2], flat, *args,
                                   dt, ACT)
        level_bytes = out[2][0].numel() * out[2][0].element_size()
        del out
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        km.reset_launches()
        got = recompute(dt)
        torch.cuda.synchronize()
        scratch = torch.cuda.max_memory_allocated() - base
        check_routes(hp, dt, f'phase 5 recompute {tag}',
                     lean_param_grads_recompute=1)
        check_chain_routes(hp, dt, f'phase 5 recompute {tag}',
                           lean_param_grads_recompute=1)
        check_wgrad_routes(hp, dt, f'phase 5 recompute {tag}',
                           lean_param_grads_recompute=1)
        again = recompute(dt)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        r_err, r_leaf = leaf_rel_err(got, want, leaf_names(hp))
        r_abs = max(float((a - b).abs().max()) for a, b in zip(got, want))
        finite = all(bool(torch.isfinite(t).all()) for t in got)
        ok = (finite and same and r_err <= RECOMPUTE_BAR
              and scratch < level_bytes)
        del got, again, want
        report('lean_param_grads_recompute', tag, ok,
               f'max leaf rel err vs lean_param_grads on the same forward '
               f'{r_err:.3e} ({r_leaf}, <= {RECOMPUTE_BAR}); two runs '
               f'bit-equal {same}; peak {scratch / 2 ** 30:.3f} GiB of '
               f'scratch, a level-sized saved stream is '
               f'{level_bytes / 2 ** 30:.3f} GiB; max|d| {r_abs:.3e}', r_abs,
               cuda_ms(lambda: recompute(dt)),
               cuda_ms(lambda: km.lean_param_grads_recompute_plain(
                   x, view, g_rgb, g_dens, flat, *args, dt, ACT)))

        # Hybrid: on the plain hybrid forward's residuals.
        res = km.lean_hybrid_fwd(x, view, flat, *args, dt, ACT)[2]
        km.reset_launches()
        got = hybrid(dt, res)
        want = hybrid(torch.float32, res, kernel=False)
        torch.cuda.synchronize()
        check_wgrad_routes(hp, dt, f'phase 5 hybrid {tag}',
                           lean_param_grads_hybrid=1)
        finite = all(bool(torch.isfinite(t).all()) for t in got)
        h_err, h_leaf = leaf_rel_err(got, want, leaf_names(hp))
        h_abs = max(float((a - b).abs().max()) for a, b in zip(got, want))
        del got, want
        report('lean_param_grads_hybrid', tag, finite and h_err <= g_bar,
               f'max leaf rel err vs the f32 plain backward {h_err:.3e} '
               f'({h_leaf}, <= {g_bar}); max|d| {h_abs:.3e}', h_abs,
               cuda_ms(lambda: hybrid(dt, res)),
               cuda_ms(lambda: hybrid(dt, res, kernel=False)))
        del res
        compare_moments_forms(results, report, flat, args, dt, tag,
                              x, view, g_rgb, g_dens, moments, enc, hp)
    compare_render_bwd_and_encode(results, report, flat, args, x, view,
                                  moments, delta, mids, enc)
    return results


def wgrad_yardstick(hp, flat, args, saved, call):
    """Phase 5, f32: the weight gradients of one lean_param_grads call on
    their own -> {ms, bound_ms, bound_by, share, library_ms}:
    wgrad_tf32_kernel's device time in a torch.profiler window of `call`;
    its bound, the products' FLOP over the M points at the 3xTF32 rate
    against the activation and cotangent rows read once and the range sums
    written once; and torch.mm on the same products (each problem's
    activation rows of `saved` against seeded cotangent rows, CUDA events),
    the library's way to these sums, never called by the port."""
    S = saved[0]
    N, depth, dcond, skip = args
    F, W = flat[0].shape
    Wv = flat[2 * (depth + 2)].shape[1]
    _, hs, bott, ys, _ = km.saved_rows(F, W, Wv, depth, dcond)
    first = [0] + hs + [bott] + ys
    shapes = [tuple(t.shape) for t in flat[0::2]]
    probs = km.wgrad_problems(shapes, depth, dcond, skip)[0]
    Cg = sum(n for _, n in shapes)
    Mp, mc = lego_wgrad_range(hp)
    M = TRAIN_RAYS * N
    gen = torch.Generator(device=S.device).manual_seed(2)
    G = torch.randn((Cg, Mp), generator=gen, device=S.device)
    blocks = [(S[first[a]:first[a] + K], G[g:g + n])
              for a, K, g, n, _, _ in probs]

    def mm():
        for a, g in blocks:
            torch.mm(a, g.t())
    library_ms = cuda_ms(mm)
    del G, blocks
    ms = sum(t for k, t in kernel_device_ms(call, iters=5).items()
             if 'wgrad_tf32_kernel' in k)
    rows = dict((a, K) for a, K, _, _, _, _ in probs)
    PW = sum(K * n for K, n in shapes)
    nbytes = 4 * ((sum(rows.values()) + Cg) * Mp + -(-Mp // mc) * PW)
    b_ms, b_by = bound('lean_param_grads', hp, TRAIN_RAYS, N, 'f32',
                       work=(sum(2 * K * n * M for _, K, _, n, _, _ in probs),
                             0, nbytes))
    log(f'[kernel] wgrad_tf32_kernel f32, the weight gradients of '
        f'lean_param_grads alone: {ms:.3f} ms device; bound {b_ms:.3f} ms '
        f'({b_by}), {100 * b_ms / ms:.1f} % of it; torch.mm on the same '
        f'products {library_ms:.3f} ms ({library_ms / ms:.2f} x the '
        f'kernel\'s time)')
    return dict(ms=ms, bound_ms=b_ms, bound_by=b_by, share=b_ms / ms,
                library_ms=library_ms)


def compare_moments_forms(results, report, flat, args, dt, tag, x,
                          view, g_rgb, g_dens, moments, enc, hp):
    """Phase 5, the moments input of the training kernels (`encode=`):
    lean_save_fwd and lean_fwd on the [6, M] moments against the f32 plain
    forward on them at the phase-3 bars, and in f32 against the same kernel
    on the encode rows of the plain decode of the same moments (<=
    FORM_BAR, max |d| / max |ref|); lean_param_grads_recompute on the
    moments against lean_param_grads on the moments forward's stream (<=
    RECOMPUTE_BAR, two runs bit-equal); CUDA-event times against the plain
    versions on the moments."""
    M = x.shape[0]
    kw = dict(encode=enc)

    def rel(got, want):
        return max(float((a - b).abs().max()) / float(b.abs().max())
                   for a, b in zip(got, want))

    rows = km.ipe_moments_plain(moments, *enc).contiguous()
    ref = fwd_parts(km.lean_mlp_save_plain(moments, view, flat, *args,
                                           torch.float32, ACT, **kw), M)
    km.reset_launches()
    out = km.lean_save_fwd(moments, view, flat, *args, dt, ACT, **kw)
    lf = km.lean_fwd(moments, view, flat, *args, dt, ACT, **kw)
    torch.cuda.synchronize()
    check_routes(hp, dt, f'phase 5 moments forwards {tag}', lean_save_fwd=1,
                 lean_fwd=1)
    got = fwd_parts(out, M)
    finite = all(bool(torch.isfinite(t).all()) for t in got)
    f_err, f_bar, f_ok = fwd_err(got, ref, dt)
    same = all(torch.equal(a, b) for a, b in zip(lf, got[:2]))
    text = f'max|d| {f_err:.3e} vs the f32 plain forward ({f_bar})'
    if dt == torch.float32:
        form = rel(got, fwd_parts(km.lean_save_fwd(rows, view, flat, *args,
                                                    dt, ACT), M))
        f_ok = f_ok and form <= FORM_BAR
        text += (f'; vs the rows form on the plain decode {form:.3e} '
                 f'(<= {FORM_BAR})')
    report('lean_save_fwd[moments]', tag, finite and f_ok, text, f_err,
           cuda_ms(lambda: km.lean_save_fwd(moments, view, flat, *args, dt,
                                            ACT, **kw)),
           cuda_ms(lambda: km.lean_mlp_save_plain(moments, view, flat, *args,
                                                  dt, ACT, **kw)),
           form='moments')
    l_err, l_bar, l_ok = fwd_err(lf, ref[:2], dt)
    report('lean_fwd[moments]', tag, same and l_ok,
           f'max|d| {l_err:.3e} ({l_bar}); bit-equal to lean_save_fwd '
           f'{same}', l_err,
           cuda_ms(lambda: km.lean_fwd(moments, view, flat, *args, dt, ACT,
                                       **kw)),
           cuda_ms(lambda: km.lean_fwd_plain(moments, view, flat, *args, dt,
                                             ACT, **kw)),
           form='moments')
    del lf, ref

    def recompute():
        return km.lean_param_grads_recompute(moments, view, g_rgb, g_dens,
                                             flat, *args, dt, ACT, **kw)
    want = km.lean_param_grads(view, g_rgb, g_dens, out[2], flat, *args, dt,
                               ACT)
    del out
    km.reset_launches()
    got, again = recompute(), recompute()
    torch.cuda.synchronize()
    check_routes(hp, dt, f'phase 5 moments recompute {tag}',
                 lean_param_grads_recompute=2)
    check_chain_routes(hp, dt, f'phase 5 moments recompute {tag}',
                       lean_param_grads_recompute=2)
    check_wgrad_routes(hp, dt, f'phase 5 moments recompute {tag}',
                       lean_param_grads_recompute=2)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    r_err, r_leaf = leaf_rel_err(got, want, leaf_names(hp))
    r_abs = max(float((a - b).abs().max()) for a, b in zip(got, want))
    finite = all(bool(torch.isfinite(t).all()) for t in got)
    del got, again, want
    report('lean_param_grads_recompute[moments]', tag,
           finite and same and r_err <= RECOMPUTE_BAR,
           f'max leaf rel err vs lean_param_grads on the same moments '
           f'forward {r_err:.3e} ({r_leaf}, <= {RECOMPUTE_BAR}); two runs '
           f'bit-equal {same}; max|d| {r_abs:.3e}', r_abs,
           cuda_ms(recompute),
           cuda_ms(lambda: km.lean_param_grads_recompute_plain(
               moments, view, g_rgb, g_dens, flat, *args, dt, ACT, **kw)),
           form='moments')


def compare_render_bwd_and_encode(results, report, flat, args, x, view,
                                  moments, delta, mids, enc):
    """Phase 5, f32 (both kernels are f32 in either compute dtype):
    lean_composite_bwd at a training level (3072 rays x 128, the f32 plain
    forward's activated heads, seeded per-ray cotangents, both
    backgrounds) against lean_composite_bwd_plain, max |d| / max |ref| <=
    FORM_BAR; ipe_moments on the level's moments against
    ipe_moments_plain, max |d| <= FORM_BAR."""
    R, N = delta.shape
    rgb, dens = km.lean_fwd_plain(x, view, flat, *args, torch.float32, ACT)
    rgbsig = torch.cat([rgb, dens], dim=-1).contiguous()
    rng = np.random.default_rng(3)
    g_perray, g_w = (torch.tensor(rng.normal(size=s).astype(np.float32),
                                  device=x.device) for s in ((R, 8), (R, N)))
    b_args = (rgbsig, delta, mids, g_perray, g_w)
    errs = []
    for white in (True, False):
        got = km.lean_composite_bwd(*b_args, white)
        want = km.lean_composite_bwd_plain(*b_args, white)
        torch.cuda.synchronize()
        if not all(bool(torch.isfinite(t).all()) for t in got):
            errs.append(float('inf'))
        errs.append(max(float((a - b).abs().max()) / float(b.abs().max())
                        for a, b in zip(got, want)))
    err = max(errs)
    report('lean_composite_bwd', 'f32', err <= FORM_BAR,
           f'max|d|/max|ref| {err:.3e} (white and black background, <= '
           f'{FORM_BAR})', err,
           cuda_ms(lambda: km.lean_composite_bwd(*b_args, True)),
           cuda_ms(lambda: km.lean_composite_bwd_plain(*b_args, True)))
    got = km.ipe_moments(moments, *enc)
    want = km.ipe_moments_plain(moments, *enc)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    ok = bool(torch.isfinite(got).all()) and err <= FORM_BAR
    del got, want
    report('ipe_moments', 'f32', ok,
           f'max|d| {err:.3e} (<= {FORM_BAR}), {moments.shape[1]:,} points',
           err, cuda_ms(lambda: km.ipe_moments(moments, *enc)),
           cuda_ms(lambda: km.ipe_moments_plain(moments, *enc)))


def compare_ipe_kernels(hp, dev):
    """Phase 5, the standalone IPE (f32 in either compute dtype): ipe_fwd
    and ipe_bwd against their plain versions on the Gaussians of a training
    level (the stratified samples of TRAIN_RAYS seeded rays, a seeded
    cotangent), with the covariances and with them zeroed (as
    disable_integration hands them over), and on a ragged number of them;
    two runs bit-equal.  dmeans reach ~1e5 and dcovs ~1e9, so they are held
    by ||a - b|| / ||b||."""
    deg = (hp['nerf.min_deg_point'], hp['nerf.max_deg_point'])
    rays, _ = train_batch(TRAIN_RAYS, dev, seed=1)
    _, (means, covs) = sample_along_rays(
        rays.origins, rays.directions, rays.radii, hp['nerf.num_samples'],
        rays.near, rays.far, False, False, 'cone')
    means = means.reshape(-1, 3).contiguous()
    covs = covs.reshape(-1, 3).contiguous()
    M = means.shape[0]
    rng = np.random.default_rng(4)
    g = torch.tensor(rng.normal(size=(M, 6 * (deg[1] - deg[0]))
                                ).astype(np.float32), device=dev)

    def rel(a, b):
        return float(torch.linalg.norm((a - b).double())
                     / torch.linalg.norm(b.double()))

    worst = {'fwd': 0.0, 'bwd': 0.0, 'bwd_abs': 0.0}
    same = True
    ragged = M - 77
    cases = (('covs', means, covs, g), ('covs = 0', means,
                                        torch.zeros_like(covs), g),
             ('ragged', means[:ragged], covs[:ragged], g[:ragged]))
    for label, m, c, gg in cases:
        out, again = ki.ipe_fwd(m, c, *deg), ki.ipe_fwd(m, c, *deg)
        dm, dc = ki.ipe_bwd(m, c, gg, *deg)
        dm2, dc2 = ki.ipe_bwd(m, c, gg, *deg)
        want = ki.ipe_fwd_plain(m, c, *deg)
        rm, rc = ki.ipe_bwd_plain(m, c, gg, *deg)
        torch.cuda.synchronize()
        finite = all(bool(torch.isfinite(t).all()) for t in (out, dm, dc))
        f_err = float((out - want).abs().max()) if finite else float('inf')
        b_err = max(rel(dm, rm), rel(dc, rc)) if finite else float('inf')
        equal = (torch.equal(out, again) and torch.equal(dm, dm2)
                 and torch.equal(dc, dc2))
        log(f'[kernel] ipe_fwd / ipe_bwd, {label}, {m.shape[0]:,} points: '
            f'forward max|d| {f_err:.3e}; dmeans {rel(dm, rm):.3e} dcovs '
            f'{rel(dc, rc):.3e} of their norms (max |dmeans| '
            f'{float(rm.abs().max()):.3e}, max |dcovs| '
            f'{float(rc.abs().max()):.3e}); two runs bit-equal {equal}')
        worst['fwd'] = max(worst['fwd'], f_err)
        worst['bwd'] = max(worst['bwd'], b_err)
        worst['bwd_abs'] = max(worst['bwd_abs'],
                               float((dm - rm).abs().max()),
                               float((dc - rc).abs().max()))
        same = same and equal
        del out, again, dm, dc, dm2, dc2, want, rm, rc
    results = {}
    report = reporter(results, hp)
    report('ipe_fwd', 'f32', same and worst['fwd'] <= FORM_BAR,
           f'max|d| {worst["fwd"]:.3e} over the three cases (<= {FORM_BAR})',
           worst['fwd'], cuda_ms(lambda: ki.ipe_fwd(means, covs, *deg)),
           cuda_ms(lambda: ki.ipe_fwd_plain(means, covs, *deg)))
    report('ipe_bwd', 'f32', same and worst['bwd'] <= FORM_BAR,
           f'||a - b|| / ||b|| {worst["bwd"]:.3e} over dmeans, dcovs and the '
           f'three cases (<= {FORM_BAR}); max|d| {worst["bwd_abs"]:.3e}',
           worst['bwd_abs'],
           cuda_ms(lambda: ki.ipe_bwd(means, covs, g, *deg)),
           cuda_ms(lambda: ki.ipe_bwd_plain(means, covs, g, *deg)))
    return results


def compare_classic_kernels(params, hp, dev, label=''):
    """Phase 5, fused_mlp's kernels at the lego level shape, the view rows
    per point (the level's view repeated over the samples, as MLP._pallas
    feeds them), f32 and bf16, bars against the f32 plain version; `label`
    is appended to the kernels' names (the model with no view layer)."""
    args = (hp['nerf.mlp.net_depth'], hp['nerf.mlp.net_depth_condition'],
            hp['nerf.mlp.skip_index'])
    N = hp['nerf.num_samples']
    flat = flat_params(params, hp)
    x, view, g_rgb, g_dens = level_inputs(hp, dev)[:4]
    view = view.repeat_interleave(N, dim=0).contiguous()
    M = x.shape[0]
    names = ['dx', 'dview'] + leaf_names(hp)
    results = {}
    report = reporter(results, hp)

    def bwd(fn, *a):
        dx, dview, grads = fn(*a)
        return [dx, dview] + list(grads)

    def finite(ts):
        return all(bool(torch.isfinite(t).all()) for t in ts)

    ref = km.mlp_save_fwd_plain(x, view, flat, *args, torch.float32)
    ref_parts = [ref[0], ref[1], ref[2][:, :M].float()]
    for dt in (torch.float32, torch.bfloat16):
        tag = 'f32' if dt == torch.float32 else 'bf16'
        bar = F32_BAR if dt == torch.float32 else BF16_BAR
        out = km.mlp_save_fwd(x, view, flat, *args, dt)
        lf = km.mlp_fwd(x, view, flat, *args, dt)
        torch.cuda.synchronize()
        parts = [out[0], out[1], out[2][:, :M].float()]
        f_err, f_bar, f_ok = fwd_err(parts, ref_parts, dt)
        report('mlp_save_fwd' + label, tag, finite(parts) and f_ok,
               f'max|d| {f_err:.3e} ({f_bar}), heads and stream', f_err,
               cuda_ms(lambda: km.mlp_save_fwd(x, view, flat, *args, dt)),
               cuda_ms(lambda: km.mlp_save_fwd_plain(x, view, flat, *args,
                                                     dt)))
        same = all(torch.equal(a, b) for a, b in zip(lf, out[:2]))
        l_err, l_bar, l_ok = fwd_err(lf, ref_parts[:2], dt)
        report('mlp_fwd' + label, tag, same and l_ok,
               f'max|d| {l_err:.3e} ({l_bar}); bit-equal to mlp_save_fwd '
               f'{same}', l_err,
               cuda_ms(lambda: km.mlp_fwd(x, view, flat, *args, dt)),
               cuda_ms(lambda: km.mlp_fwd_plain(x, view, flat, *args, dt)))
        del lf, parts

        # The saved backward on the plain forward's stream.
        saved = ref[2] if dt == torch.float32 else \
            km.mlp_save_fwd_plain(x, view, flat, *args, dt)[2]
        km.reset_launches()
        got = bwd(km.mlp_bwd_saved, g_rgb, g_dens, saved, flat, *args, dt)
        want = bwd(km.mlp_bwd_saved_plain, g_rgb, g_dens, saved, flat, *args,
                   torch.float32)
        torch.cuda.synchronize()
        check_wgrad_routes(hp, dt, f'phase 5 mlp_bwd_saved{label} {tag}',
                           mlp_bwd_saved=1)
        g_err, g_leaf = leaf_rel_err(got, want, names)
        g_abs = max(float((a - b).abs().max()) for a, b in zip(got, want))
        extra = ''
        if dt == torch.float32:
            own = bwd(km.mlp_bwd_saved, g_rgb, g_dens, out[2], flat, *args,
                      dt)
            o_err, o_leaf = leaf_rel_err(own, want, names)
            extra = f'; fed its own forward\'s stream {o_err:.3e} ({o_leaf})'
            del own
        report('mlp_bwd_saved' + label, tag, finite(got) and g_err <= bar,
               f'max rel err of dx, dview and the leaves vs the f32 plain '
               f'backward {g_err:.3e} ({g_leaf}, <= {bar}){extra}; max|d| '
               f'{g_abs:.3e}', g_abs,
               cuda_ms(lambda: km.mlp_bwd_saved(g_rgb, g_dens, saved, flat,
                                                *args, dt)),
               cuda_ms(lambda: km.mlp_bwd_saved_plain(g_rgb, g_dens, saved,
                                                      flat, *args, dt)))
        del got, want, saved

        # Recompute: against the saved backward on the kernel forward's
        # stream (the forward it re-runs), twice.
        def recompute():
            return bwd(km.mlp_bwd_recompute, x, view, g_rgb, g_dens, flat,
                       *args, dt)
        want = bwd(km.mlp_bwd_saved, g_rgb, g_dens, out[2], flat, *args, dt)
        del out
        km.reset_launches()
        got, again = recompute(), recompute()
        torch.cuda.synchronize()
        check_wgrad_routes(hp, dt, f'phase 5 mlp_bwd_recompute{label} {tag}',
                           mlp_bwd_recompute=2)
        runs = all(torch.equal(a, b) for a, b in zip(got, again))
        inputs = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        r_err, r_leaf = leaf_rel_err(got, want, names)
        r_abs = max(float((a - b).abs().max()) for a, b in zip(got, want))
        ok = finite(got) and runs and inputs and r_err <= RECOMPUTE_BAR
        del got, again, want
        report('mlp_bwd_recompute' + label, tag, ok,
               f'max rel err vs mlp_bwd_saved on the same forward '
               f'{r_err:.3e} ({r_leaf}, <= {RECOMPUTE_BAR}); dx and dview '
               f'bit-equal {inputs}; two runs bit-equal {runs}; max|d| '
               f'{r_abs:.3e}', r_abs, cuda_ms(recompute),
               cuda_ms(lambda: km.mlp_bwd_recompute_plain(
                   x, view, g_rgb, g_dens, flat, *args, dt)))
    return results


def pair_inputs(M, f_in, Wl, Wout, dev, seed):
    """One pair's numpy-seeded inputs, f32: x, Wcol, bcol, Wrow and the
    partial's cotangent.  tp_lean_forward hands the first pair f32 encode
    rows and a later one (f_in = the trunk width) post-ReLU activations in
    the compute dtype: the caller casts."""
    rng = np.random.default_rng(seed)

    def t(shape, scale=1.0):
        return torch.tensor(rng.standard_normal(shape, np.float32) * scale,
                            device=dev)
    return (t((M, f_in)), t((f_in, Wl), 1 / np.sqrt(f_in)), t((1, Wl), 0.1),
            t((Wl, Wout), 1 / np.sqrt(Wl)), t((M, Wout)))


def settled_cotangent(args, g, dt, margin=1e-4):
    """g with the rows zeroed in which some pre-activation of the pair lies
    within `margin` of zero, and the share of rows kept.  The backward
    kernel recomputes the pre-activation and takes its ReLU mask from its
    own sums, ~1e-6 from the plain version's: where a pre-activation is
    that close to zero the two masks may differ, and each flip moves a
    whole term of dx, dWcol and dbcol.  With no cotangent in those rows
    both backwards provably take the same mask wherever it matters."""
    x, w_col, b_col, _ = args
    hpre = x.to(dt).float() @ w_col.to(dt).float() + b_col
    keep = (hpre.abs() > margin).all(dim=1, keepdim=True)
    return g * keep, float(keep.float().mean())


def compare_pair_kernels(hp, dev):
    """Phase 5, the Megatron pair kernels at the three pair shapes of a lego
    level at net_width 1024 on a model axis of 2 (the first pair: f32 encode
    rows, f_in 96; a later pair; the skip pair, whose kernel sees the same
    shapes: its x-rows term is added outside), 393,216 rows and a ragged
    count, f32 and bf16.  Forward against the f32 `_pair_plain` at the
    phase-3 bars; dx, dWcol, dbcol and dWrow at the largest ||a - b|| /
    ||b|| against the f32 `_pair_bwd_plain` on x and the panels as the
    kernel rounds them, with a cotangent that is zero in the rows whose
    ReLU mask is in doubt (settled_cotangent), <= 1e-4 f32, <= 3e-2 bf16;
    two backward runs bit-equal.  The numbers of the later
    pair at the level's rows are the kernels' record."""
    W, _, n_model = TP_MESHES[0]
    Wl = W // n_model
    F = 6 * (hp['nerf.max_deg_point'] - hp['nerf.min_deg_point'])
    M = TRAIN_RAYS * hp['nerf.num_samples']
    names = ['dx', 'dWcol', 'dbcol', 'dWrow']
    cases = [('first pair', M, F, 11), ('pair', M, W, 12),
             ('skip pair', M, W, 13), ('pair, ragged', TP_RAGGED_ROWS, W, 14),
             ('first pair, ragged', TP_RAGGED_ROWS, F, 15)]
    results = {}
    report = reporter(results, hp)
    for label, rows, f_in, seed in cases:
        x32, *panels, g = pair_inputs(rows, f_in, Wl, W, dev, seed)
        for dt in (torch.float32, torch.bfloat16):
            tag = 'f32' if dt == torch.float32 else 'bf16'
            g_bar = F32_BAR if dt == torch.float32 else BF16_BAR
            args = [torch.relu(x32).to(dt) if f_in == W else x32] + panels
            g, kept = settled_cotangent(args, g, dt)
            out = kt._pair_call(*args, dt)
            km.reset_launches()
            got = kt._pair_bwd_call(*args, g, dt)
            again = kt._pair_bwd_call(*args, g, dt)
            torch.cuda.synchronize()
            check_wgrad_routes(hp, dt, f'phase 5 tp_pair_bwd, {label} {tag}',
                               tp_pair_bwd=2)
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            del again
            ref = kt._pair_plain(*args, torch.float32)
            finite = bool(torch.isfinite(out).all()) and all(
                bool(torch.isfinite(t).all()) for t in got)
            f_err, f_bar, f_ok = fwd_err([out], [ref], dt)
            del out, ref
            x, w_col, b_col, w_row = args
            want = kt._pair_bwd_plain(x.to(dt), w_col.to(dt), b_col,
                                      w_row.to(dt), g, torch.float32)
            g_err, g_leaf = leaf_rel_err(got, want, names)
            g_abs = max(float((a - b).abs().max())
                        for a, b in zip(got, want))
            del got, want
            log(f'[kernel] tp_pair_fwd / tp_pair_bwd, {label}, {rows:,} rows'
                f' x {f_in} -> {Wl} -> {W}, {tag}: forward max|d| '
                f'{f_err:.3e} ({f_bar}); backward max rel err {g_err:.3e} '
                f'({g_leaf}, <= {g_bar}; {100 * kept:.2f} % of the rows carry '
                f'a cotangent), two runs bit-equal {same}')
            if not (finite and same and f_ok and g_err <= g_bar):
                raise AssertionError(f'the pair kernels disagree with their '
                                     f'plain versions: {label} {tag}')
            if rows != M or label == 'skip pair':
                continue
            suffix = '' if f_in == W else '[first pair]'
            x_f32 = args[0].dtype == torch.float32
            for name, err, kernel, plain in (
                    ('tp_pair_fwd', f_err,
                     lambda: kt._pair_call(*args, dt),
                     lambda: kt._pair_plain(*args, dt)),
                    ('tp_pair_bwd', g_abs,
                     lambda: kt._pair_bwd_call(*args, g, dt),
                     lambda: kt._pair_bwd_plain(*args, g, dt))):
                report(name + suffix, tag, True,
                       f'{label}, the checks above', err, cuda_ms(kernel),
                       cuda_ms(plain, 2),
                       work=pair_work(name, rows, f_in, Wl, W, tag, x_f32))
            del args
    return results


def settled_points(x, view, flat, N, depth, dcond, skip, margin=1e-5):
    """[M, 1] f32: 1 for the points none of whose ReLU pre-activations in
    the f32 lean forward lies within `margin` of zero, else 0.  Two f32
    forwards that sum in another order differ by ~1e-7 in a pre-activation
    (their heads by 4e-6 at net_width 1024); a cotangent that is zero on
    the other points makes their ReLU masks agree wherever a gradient
    passes (see settled_cotangent).  The level's pre-activations are dense
    near zero (zero biases, ~4 a unit a point at net_width 1024): a margin
    of 5e-5 leaves 2.5 % of the points."""
    with torch.no_grad():
        W = flat[0].shape[1]
        worst = torch.full((x.shape[0],), float('inf'), device=x.device)

        def relu_of(pre):
            torch.minimum(worst, pre.abs().amin(dim=1), out=worst)
            return torch.relu(pre)
        h = x
        for i in range(depth):
            h = relu_of(h @ flat[2 * i] + flat[2 * i + 1])
            if i % skip == 0 and i > 0:
                h = torch.cat([h, x], dim=-1)
        bott = h @ flat[2 * depth + 2] + flat[2 * depth + 3]
        iv = 2 * (depth + 2)
        per_ray = view @ flat[iv][W:] + flat[iv + 1]
        y = relu_of(bott @ flat[iv][:W] + per_ray.repeat_interleave(N, dim=0))
        for j in range(1, dcond):
            y = relu_of(y @ flat[iv + 2 * j] + flat[iv + 2 * j + 1])
        return (worst > margin).float()[:, None]


def tp_slice(hp0, params0, dev):
    """The TP slice: tp_lean_forward on a single-process mesh on the card, a
    lego level (3072 rays x 128 samples, the level's encode rows and view
    features), at net_width 1024 on 2 shards (model axis 2) and at
    net_width 256 on 8 (model axis 4), bf16 and f32: the forward and the
    gradient of a seeded linear loss against the port's full-width plain
    lean forward on the card.  Forward at the phase-3 bars against the f32
    plain forward; dx, dview and every leaf at the largest ||a - b|| / ||b||
    against autograd of the plain forward in the same compute dtype, <=
    3e-2 bf16, <= 1e-4 f32.  The loss's cotangents are zero on the points
    whose ReLU masks are in doubt between two f32 forwards
    (settled_points; with them every f32 leaf reads ~5e-3 off through mask
    flips, trunk_0.bias the most).  The pair
    kernels must launch once a pair, model rank and data shard.  Prints ms
    of the forward and of forward + backward (best of 4) and the peak
    memory, beside the plain forward's; -> the launch counts of the first
    mesh's bf16 run."""
    N = hp0['nerf.num_samples']
    x, view, g_rgb, g_dens = level_inputs(hp0, dev)[:4]
    counts = None
    for W, shards, n_model in TP_MESHES:
        hp = dict(hp0, **{'nerf.mlp.net_width': W})
        params = params0 if W == hp0['nerf.mlp.net_width'] else \
            jax_params_to_torch(flax_tree(MipNeRFSystem(hp, device=dev),
                                          seed=0), device=dev)
        cfg = (hp['nerf.mlp.net_depth'], hp['nerf.mlp.net_depth_condition'],
               hp['nerf.mlp.skip_index'])
        mesh = create_mesh(num_devices=shards, model_axis=n_model)
        if mesh.device.type != 'cuda' or mesh.shape != {
                'data': shards // n_model, 'model': n_model}:
            raise AssertionError(f'unexpected mesh {mesh.shape} on '
                                 f'{mesh.device}')
        leaves = [x, view] + flat_params(params, hp)
        keep = settled_points(*leaves[:2], leaves[2:], N, *cfg)
        c_rgb, c_dens = g_rgb * keep, g_dens * keep
        log(f'[tp] net_width {W}: {100 * float(keep.mean()):.2f} % of the '
            f'points carry a cotangent')
        leaves = [t.detach().clone().requires_grad_(True) for t in leaves]
        names = ['dx', 'dview'] + leaf_names(hp)
        want_launches = cfg[0] // 2 * shards

        def run(fwd, backward=True):
            out = fwd(leaves[0], leaves[1], leaves[2:])
            if not backward:
                return [o.detach() for o in out], None
            loss = (out[0] * c_rgb).sum() + (out[1] * c_dens).sum()
            return ([o.detach() for o in out],
                    torch.autograd.grad(loss, leaves))

        def timed(fwd, backward):
            """(best ms of 4, peak GiB)."""
            best = float('inf')
            torch.cuda.reset_peak_memory_stats()
            for _ in range(4):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run(fwd, backward)
                torch.cuda.synchronize()
                best = min(best, time.perf_counter() - t0)
            return best * 1e3, torch.cuda.max_memory_allocated() / 2 ** 30

        ref32 = None
        for dt in (torch.bfloat16, torch.float32):
            tag = 'f32' if dt == torch.float32 else 'bf16'

            def tp(x_, v_, fl):
                return kt.tp_lean_forward(x_, v_, fl, mesh, N, *cfg, dt)

            def plain(x_, v_, fl, dtype=dt):
                return km.lean_fwd_plain(x_, v_, fl, N, *cfg, dtype, None)

            km.reset_launches()
            out, grads = run(tp)
            torch.cuda.synchronize()
            run_counts = dict(km.launches)
            counts = counts or run_counts
            if ref32 is None:
                ref32 = run(lambda *a: plain(*a, dtype=torch.float32),
                            backward=False)[0]
            f_err, f_bar, f_ok = fwd_err(out, ref32, dt)
            want = run(plain)[1]
            g_bar = F32_BAR if dt == torch.float32 else BF16_BAR
            g_err, g_leaf = leaf_rel_err(grads, want, names)
            finite = all(bool(torch.isfinite(t).all())
                         for t in list(out) + list(grads))
            pairs = {k: run_counts[k] for k in ('tp_pair_fwd', 'tp_pair_bwd')}
            ok = (finite and f_ok and g_err <= g_bar
                  and all(v == want_launches for v in pairs.values())
                  and not any(v for k, v in run_counts.items()
                              if k not in pairs))
            log(f'[tp] net_width {W}, mesh data {shards // n_model} x model '
                f'{n_model}, {tag}: launches {pairs} (expected '
                f'{want_launches} each); forward max|d| {f_err:.3e} '
                f'({f_bar}) vs the f32 plain forward; gradients max rel err '
                f'{g_err:.3e} ({g_leaf}, <= {g_bar}) vs the {tag} plain '
                f'forward\'s  {"OK" if ok else "FAIL"}')
            if not ok:
                raise AssertionError(f'the TP slice disagrees with the '
                                     f'full-width plain forward: {W} {tag}')
            del out, grads, want
            with torch.no_grad():
                f_ms, f_peak = timed(tp, False)
                pf_ms, pf_peak = timed(plain, False)
            b_ms, b_peak = timed(tp, True)
            pb_ms, pb_peak = timed(plain, True)
            log(f'[tp] net_width {W} model {n_model} {tag}: forward '
                f'{f_ms:.1f} ms (peak {f_peak:.2f} GiB), forward + backward '
                f'{b_ms:.1f} ms (peak {b_peak:.2f} GiB); the plain '
                f'full-width forward {pf_ms:.1f} ms ({pf_peak:.2f} GiB), '
                f'forward + backward {pb_ms:.1f} ms ({pb_peak:.2f} GiB); '
                f'best of 4')
        del leaves, ref32, params, keep, c_rgb, c_dens
        torch.cuda.empty_cache()
    return counts


def run_k_steps(system, params, stack, pix, names, levels, label):
    """K steps of make_train_many from `params`: each kernel in `names`
    must launch `levels` (or PER_STEP's count) x K times, lean_mlp never,
    every call of a lean forward, of a lean chain and of a backward's
    weight gradients on the route its rule gives (check_routes,
    check_chain_routes, check_wgrad_routes), and the loss must stay
    finite; -> the run's launch counts."""
    fn = system.make_train_many()
    state = system.init_state(params=params)
    km.reset_launches()
    state, aux, sec, _ = train_run(fn, state, stack, pix)
    run_counts = dict(km.launches)
    hp = system.hparams
    dt = getattr(torch, str(hp.get('train.compute_dtype', 'float32')))
    fwd = {n: run_counts[n] for n in km.routes if run_counts[n]}
    chain = {n: run_counts[n] for n in km.chain_routes if run_counts[n]}
    wgrad = {n: run_counts[n] for n in km.wgrad_tf32_routes if run_counts[n]}
    if fwd:
        check_routes(hp, dt, f'{label} K={TRAIN_K}', **fwd)
    if chain:
        check_chain_routes(hp, dt, f'{label} K={TRAIN_K}', **chain)
    if wgrad:
        check_wgrad_routes(hp, dt, f'{label} K={TRAIN_K}', **wgrad)
    losses = aux['loss'].cpu().numpy()
    log(f'[train] {label} make_train_many K={TRAIN_K}: launches '
        f'{ {n: run_counts[n] for n in names} }; loss '
        f'{np.array2string(losses, precision=5)}; first call {sec:.3f} s')
    for name in names:
        expected = PER_STEP.get(name, levels) * TRAIN_K
        if run_counts[name] != expected:
            raise AssertionError(f'{name} launched {run_counts[name]} times, '
                                 f'expected {expected}')
    for name in ('ipe_fwd', 'ipe_bwd'):
        if name not in names and run_counts[name]:
            raise AssertionError(f'{label} launched {name}')
    if run_counts['lean_mlp']:
        raise AssertionError(f'{label}: the training step launched the '
                             'render-only lean_mlp')
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f'non-finite training loss: {losses}')
    return run_counts


def no_view_slice(hp0, params, dev):
    """Phase 6, a model with no view layer (net_depth_condition 0, `params`
    its seeded weights) on pallas_save with stop_resample_grad False, bf16
    and f32: the one-step gradient gate against the plain path, then K
    steps in which mlp_save_fwd and mlp_bwd_saved launch 2 levels x K
    times."""
    rays, pixels = train_batch(TRAIN_RAYS, dev)
    stack = Rays(*(f.expand(TRAIN_K, *f.shape).contiguous() for f in rays))
    pix = pixels.expand(TRAIN_K, *pixels.shape).contiguous()
    for dtype in ('bfloat16', 'float32'):
        hb = dict(hp0, **{'train.compute_dtype': dtype,
                          'nerf.mlp_backend': 'pallas_save'}, **_RESAMPLE)
        label = f'{dtype} pallas_save+resample, no view layer'
        system = gradient_gate(hb, params, rays, pixels, dev, label)
        run_k_steps(system, params, stack, pix,
                    ('mlp_save_fwd', 'mlp_bwd_saved'),
                    hp0['nerf.num_levels'], label)


def train_run(fn, state, stack, pixels):
    """One make_train_many call, timed on the host clock to a synchronise;
    -> (state, aux, seconds, peak GiB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, aux = fn(state, stack, pixels, 0)
    torch.cuda.synchronize()
    return (state, aux, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() / 2 ** 30)


def gradient_gate(hp, params, rays, pixels, dev, label, resample_term=False):
    """One value_and_grad of the kernel system and of the same system on
    the plain 'xla' backend, the same generator seed; -> the kernel
    system.  resample_term: also the plain path with stop_resample_grad
    True, whose difference from the plain path is the size of the
    resample gradient the gate must see."""
    plain = dict(hp, **{'nerf.mlp_backend': 'xla', 'nerf.ipe_backend': 'xla'})
    systems = {'kernel': MipNeRFSystem(hp, device=dev),
               'plain': MipNeRFSystem(plain, device=dev)}
    if hp.get('nerf.ipe_backend') == 'pallas':
        # The plain MLP on the kernel's encode: what the gate falls back to
        # if the two encodes' cosine halves differ by more than the bar.
        systems['plain+ipe'] = MipNeRFSystem(
            dict(plain, **{'nerf.ipe_backend': 'pallas'}), device=dev)
    if resample_term:
        systems['stopped'] = MipNeRFSystem(
            dict(plain, **{'nerf.stop_resample_grad': True}), device=dev)
    grads = {}
    for name, s in systems.items():
        st = s.init_state(params=params)
        _, g = s.value_and_grad(st['params'], rays, pixels,
                                s.step_generator(7, 0))
        grads[name] = [g[k] for k in sorted(g)]
    torch.cuda.synchronize()
    err, leaf = leaf_rel_err(grads['kernel'], grads['plain'], sorted(params))
    bar = BF16_BAR if hp['train.compute_dtype'] == 'bfloat16' \
        else F32_GATE_BAR
    term = ''
    if resample_term:
        t_err, t_leaf = leaf_rel_err(grads['stopped'], grads['plain'],
                                     sorted(params))
        term = (f'; the plain path with stop_resample_grad True differs '
                f'from it by {t_err:.3e} ({t_leaf})')
    if 'plain+ipe' in grads:
        s_err, s_leaf = leaf_rel_err(grads['kernel'], grads['plain+ipe'],
                                     sorted(params))
        term += (f'; vs the plain MLP on the kernel encode {s_err:.3e} '
                 f'({s_leaf})')
        if err > bar:
            log(f'[train] {label}: the default encode\'s gradients differ '
                f'by {err:.3e} ({leaf}) > {bar}; the gate is held against '
                f'the plain MLP on nerf.ipe_backend pallas')
            err, leaf = s_err, s_leaf
    log(f'[train] {label} one-step gradient parity vs xla: max leaf rel err '
        f'{err:.3e} ({leaf}, <= {bar}) {"OK" if err <= bar else "FAIL"}'
        f'{term}')
    if err > bar:
        raise AssertionError(f'{label}: training gradients disagree with the '
                             'plain path')
    return systems['kernel']


def train_slice(hp0, params, dev):
    """Phase 6, bf16 then f32, every training configuration; -> the launch
    counts of each configuration's K-step run (bf16)."""
    rays, pixels = train_batch(TRAIN_RAYS, dev)
    K = TRAIN_K
    stack = Rays(*(f.expand(K, *f.shape).contiguous() for f in rays))
    pix = pixels.expand(K, *pixels.shape).contiguous()
    levels = hp0['nerf.num_levels']
    counts = {}
    for dtype in ('bfloat16', 'float32'):
        hp = dict(hp0, **{'train.compute_dtype': dtype})
        plain = dict(hp, **{'nerf.mlp_backend': 'xla'})
        # The plain path with the resample gradient: what the classic
        # configurations are compared with.
        systems = {'plain': MipNeRFSystem(plain, device=dev),
                   'plain+resample': MipNeRFSystem(dict(plain, **_RESAMPLE),
                                                   device=dev)}
        for label, (backend, opts, names) in TRAIN_CONFIGS.items():
            hb = dict(hp, **{'nerf.mlp_backend': backend}, **opts)
            system = gradient_gate(hb, params, rays, pixels, dev,
                                   f'{dtype} {label}',
                                   label in CLASSIC_CONFIGS)
            model = system.model
            gates = {'nerf.fuse_render': model._fused_render,
                     'nerf.fuse_encode': model._fused_encode,
                     'nerf.pallas_encode': model._pallas_encode}
            # The lean kernels apply the head activations; fused_mlp
            # returns raw heads, as in JAX.
            if model._fused_act != (backend in LEAN_BACKENDS) or any(
                    gates[k] != bool(opts.get(k)) for k in gates):
                raise AssertionError(f'{label} did not select its path: '
                                     f'fused activations {model._fused_act}'
                                     f', {gates}')
            run_counts = run_k_steps(system, params, stack, pix, names,
                                     levels, f'{dtype} {label}')
            counts.setdefault(label, run_counts)
            systems[label] = system
        if dtype == 'float32' and time.perf_counter() - START > F32_TURNS_BY:
            log(f'[train] float32: past {F32_TURNS_BY} s, the timing turns of '
                f'{", ".join(NEW_CONFIGS)} are cut')
            for label in NEW_CONFIGS:
                del systems[label]
        states = {n: s.init_state(params=params) for n, s in systems.items()}
        fns = {n: s.make_train_many() for n, s in systems.items()}
        for which in ('plain', 'plain+resample'):        # warm-up
            states[which], _, _, _ = train_run(fns[which], states[which],
                                               stack, pix)
        order = list(systems)
        times = {n: [] for n in order}
        for which in (order + order[::-1]) * TURN_ROUNDS:
            states[which], aux, sec, peak = train_run(
                fns[which], states[which], stack, pix)
            if not torch.isfinite(aux['loss']).all():
                raise AssertionError(f'non-finite loss on the {which} path')
            times[which].append((sec, peak))
            log(f'[train] {dtype} {which}: {sec * 1e3 / K:.2f} ms/step, '
                f'{TRAIN_RAYS * K / sec:,.0f} rays/s, peak {peak:.2f} GiB')
        for which, v in times.items():
            secs = sorted(t[0] for t in v)
            best, median = secs[0], float(np.median(secs))
            log(f'[train] {dtype} {which} best of {len(v)}: '
                f'{best * 1e3 / K:.2f} ms/step ({TRAIN_RAYS * K / best:,.0f} '
                f'rays/s), median {median * 1e3 / K:.2f}, spread '
                f'{(secs[-1] - best) * 1e3 / K:.2f} ms/step, peak '
                f'{max(t[1] for t in v):.2f} GiB')
        del systems, states, fns

    # Raw heads on the card: density noise leaves the activations to the
    # model, so the kernels run with act=None.
    hn = dict(hp0, **{'nerf.mlp_backend': 'pallas_lean',
                      'train.compute_dtype': 'float32',
                      'nerf.density_noise': 1.0})
    km.reset_launches()
    system = gradient_gate(hn, params, rays, pixels, dev,
                           'float32 pallas_lean density_noise 1.0')
    if system.model._fused_act or system.model.mlp.fused_activation:
        raise AssertionError('density_noise > 0 kept the fused activations')
    if not (km.launches['lean_fwd'] and
            km.launches['lean_param_grads_recompute']):
        raise AssertionError(f'the raw-heads gate ran no lean kernel: '
                             f'{km.launches}')
    return counts


def render_frame(system, params, cam, side=None):
    side = side or SIDE
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = system.render_camera(params, cam, side, side, chunk_size=CHUNK,
                               need_coarse=False)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def blender_camera(side, dev):
    """Blender view on the radius-4 orbit, focal scaled from 800 px,
    near 2, far 6."""
    pose = create_spheric_poses(4.0, n_poses=8)[1].astype(np.float32)
    p2c = pix2cam_from_focal(side, side, 1111.11 * side / 800)
    return Camera(torch.tensor(pose, device=dev),
                  torch.tensor(p2c, device=dev), 2.0, 6.0, 1.0)


def device_ms(events) -> float:
    """Kernel time in a profile: the device rows only (a CPU op or an
    autograd Function that launched a kernel repeats its time)."""
    from torch.autograd import DeviceType
    return sum(e.self_device_time_total for e in events
               if e.device_type == DeviceType.CUDA) / 1e3


def measure(hp, params, dev):
    """800x800 frame times, kernel vs plain path in turns, f32 and bf16;
    then a profiler table of one 200x200 kernel-path frame."""
    from torch.profiler import ProfilerActivity, profile
    cam = blender_camera(FULL_SIDE, dev)
    small = blender_camera(SIDE, dev)
    for dtype in ('float32', 'bfloat16'):
        pair = {}
        for backend in ('auto', 'xla'):
            sysb = MipNeRFSystem(dict(hp, **{'val.mlp_backend': backend,
                                             'train.compute_dtype': dtype}),
                                 device=dev)
            render_frame(sysb, params, small)              # warm-up
            pair['kernel' if backend == 'auto' else 'plain'] = sysb
        times = {'kernel': [], 'plain': []}
        for which in ('kernel', 'plain', 'plain', 'kernel'):
            torch.cuda.reset_peak_memory_stats()
            _, sec = render_frame(pair[which], params, cam, FULL_SIDE)
            times[which].append(sec)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            log(f'[measure] {FULL_SIDE}x{FULL_SIDE} {dtype} {which}: '
                f'{sec:.3f} s/frame (peak {peak:.2f} GiB)')
        log(f'[measure] {FULL_SIDE}x{FULL_SIDE} {dtype}: kernel '
            f'{min(times["kernel"]):.3f} s/frame, plain '
            f'{min(times["plain"]):.3f} s/frame (best of 2 each)')
    sysk = MipNeRFSystem(hp, device=dev)
    render_frame(sysk, params, small)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, sec = render_frame(sysk, params, small)
    events = prof.key_averages()
    dev_ms = device_ms(events)
    log(f'[measure] profile of one {SIDE}x{SIDE} f32 kernel-path frame: '
        f'wall {sec * 1e3:.1f} ms, device time {dev_ms:.1f} ms '
        f'(busy {dev_ms / 10 / sec:.1f}%)')
    log(events.table(sort_by='self_device_time_total', row_limit=12,
                     max_name_column_width=60))
    rays, pixels = train_batch(TRAIN_RAYS, dev)
    runs = [(label, 'bfloat16')
            for label in list(TRAIN_CONFIGS)[:3] + [PROFILED_CONFIG]]
    runs += [(label, 'bfloat16') for label in CLASSIC_CONFIGS]
    runs += [('pallas_lean_save', 'float32'), (PROFILED_CONFIG, 'float32')]
    for label, dtype in runs:
        backend, opts, _ = TRAIN_CONFIGS[label]
        systr = MipNeRFSystem(dict(hp, **{'nerf.mlp_backend': backend,
                                          'train.compute_dtype': dtype},
                                   **opts), device=dev)
        state = systr.init_state(params=params)
        systr.train_step(state, rays, pixels, systr.step_generator(0, 0))
        torch.cuda.synchronize()
        # The host's issue time of a step (nothing in it synchronises)
        # against its time to the synchronise.
        t0 = time.perf_counter()
        systr.train_step(state, rays, pixels, systr.step_generator(0, 1))
        issue = time.perf_counter() - t0
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            systr.train_step(state, rays, pixels, systr.step_generator(0, 2))
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
        events = prof.key_averages()
        dev_ms = device_ms(events)
        log(f'[measure] {dtype} {label} train step: host issue '
            f'{issue * 1e3:.1f} ms of {total * 1e3:.1f} ms to the '
            f'synchronise; profiled: wall {sec * 1e3:.1f} ms, device time '
            f'{dev_ms:.1f} ms (busy {dev_ms / 10 / sec:.1f}%)')
        log(events.table(sort_by='self_device_time_total', row_limit=15,
                         max_name_column_width=60))
        del systr, state


class SphereViews(Blender):
    """The synthetic sphere scene of data/synthetic.py held in memory: the
    views make_sphere_scene would write (the same orbit poses and strides),
    ray-traced by render_sphere_view and composited as the file path
    composites them, with no image file read or written."""

    def _load_renderings(self):
        n = RUN_VIEWS[self.split]
        poses = create_spheric_poses(4.0, n_poses=max(n * 3,
                                                      RUN_VIEWS['train']))
        poses = poses[::max(1, len(poses) // max(n, 1))][:n]
        self.camtoworlds, self.images = [], []
        for pose in poses:
            c2w = np.eye(4)
            c2w[:3, :4] = pose
            rgba = render_sphere_view(c2w, RUN_SIDE).astype(np.float32)
            self.camtoworlds.append(c2w.astype(np.float32))
            self.images.append(_alpha_composite(rgba, self.white_bkgd))
        self.h = self.w = RUN_SIDE
        self.focal = 0.5 * self.w / np.tan(0.5 * CAMERA_ANGLE_X)


def whole_run(hp0):
    """Phase 7: train CLI -> checkpoint -> resume -> eval CLI on the
    in-memory sphere scene; -> the launch counts of the first train call."""
    dataset_dict['sphere_memory'] = SphereViews
    levels = hp0['nerf.num_levels']
    with tempfile.TemporaryDirectory() as out_dir:
        def train_args(max_steps):
            return ['--data_path', 'memory', '--out_dir', out_dir,
                    '--dataset_name', 'sphere_memory', '--max_steps',
                    str(max_steps), 'exp_name', 'smoke',
                    'train.compute_dtype', 'bfloat16', 'nerf.mlp_backend',
                    'pallas_save', 'nerf.stop_resample_grad', 'False',
                    'nerf.ipe_backend', 'pallas', 'train.batch_size',
                    str(TRAIN_RAYS), 'train.steps_per_call', str(RUN_K),
                    'val.check_interval', str(RUN_VAL), 'val.sample_num', '1',
                    'optimizer.lr_delay_steps', '0']

        km.reset_launches()
        system, state = train_cli.main(train_args(RUN_STEPS))
        counts = dict(km.launches)
        stats = system.fit_stats
        log(f'[run] cli.train {RUN_STEPS} steps of {TRAIN_RAYS} rays, bf16 '
            f'pallas_save + resample + ipe_backend pallas: loss '
            f'{stats["loss_first"]:.5f} at step {RUN_K} -> '
            f'{stats["loss_last"]:.5f} at step {RUN_STEPS}; '
            f'{stats["rays_per_sec"]:,.0f} rays/s over the training time; '
            f'the loop waited on the batcher for '
            f'{100 * stats["data_wait_share"]:.2f} % of its '
            f'{stats["loop_seconds"]:.2f} s; launches '
            f'{ {k: v for k, v in counts.items() if v} }')
        if state['step'] != RUN_STEPS or stats['steps'] != RUN_STEPS:
            raise AssertionError(f'the run ended at step {state["step"]}')
        if not (np.isfinite(stats['loss_last'])
                and stats['loss_last'] < stats['loss_first']):
            raise AssertionError(f'the loss did not fall: {stats}')
        # 2 encodes a step, and 2 a chunk of a validation frame (the sanity
        # frame and one at each validation); the VJP once a step.
        chunks = (1 + RUN_STEPS // RUN_VAL) * -(-RUN_SIDE ** 2
                                                // system.val_chunk_size)
        want = {'ipe_fwd': levels * (RUN_STEPS + chunks), 'ipe_bwd': RUN_STEPS,
                'mlp_save_fwd': levels * RUN_STEPS,
                'mlp_bwd_saved': levels * RUN_STEPS}
        if any(counts[k] != want.get(k, 0) for k in counts):
            raise AssertionError(f'the run launched {counts}, expected '
                                 f'{want} and nothing else')
        ckpt_dir = os.path.join(out_dir, 'ckpt', 'smoke')
        best = sorted(os.listdir(os.path.join(ckpt_dir, 'best')), key=int)
        last = os.listdir(os.path.join(ckpt_dir, 'last'))
        log(f'[run] checkpoints: best {best} last {last}')
        if best != [str(RUN_VAL), str(RUN_STEPS)] or last != [str(RUN_STEPS)]:
            raise AssertionError('unexpected checkpoints')

        # The resumed call also traces its second dispatch (--profile).
        system, state = train_cli.main(['--profile', '1']
                                       + train_args(RUN_RESUMED_STEPS))
        resumed = system.fit_stats['steps']
        if not os.path.exists(os.path.join(out_dir, 'logs', 'smoke',
                                           'train_dispatch.json')):
            raise AssertionError('--profile wrote no trace')
        log(f'[run] second call with --max_steps {RUN_RESUMED_STEPS}: '
            f'{resumed} more steps, ended at step {state["step"]}, loss '
            f'{system.fit_stats["loss_last"]:.5f}')
        if (state['step'] != RUN_RESUMED_STEPS
                or resumed != RUN_RESUMED_STEPS - RUN_STEPS
                or not np.isfinite(system.fit_stats['loss_last'])):
            raise AssertionError('the second call did not resume at step '
                                 f'{RUN_STEPS}')

        summary = eval_cli.main(['--ckpt', ckpt_dir, '--out_dir', out_dir,
                                 '--scale', '1', '--no_video', '--chunk_size',
                                 str(CHUNK)])
        values = {}
        for name in ('psnrs', 'ssims'):
            with open(os.path.join(out_dir, 'test', 'smoke',
                                   f'{name}.txt')) as f:
                values[name] = [float(v) for v in f.read().split()]
        log(f'[run] cli.eval: {values}; summary {summary}')
        if (any(len(v) != RUN_VIEWS['test'] or not np.all(np.isfinite(v))
                for v in values.values())
                or not all(np.isfinite(float(v))
                           for v in summary.split(' | '))):
            raise AssertionError('eval wrote no finite metrics')
    return counts


class RecordingWriter:
    """A TensorBoard writer's interface that keeps the images it is
    given."""

    def __init__(self):
        self.images = []

    def add_scalar(self, tag, value, step):
        pass

    def add_images(self, tag, value, step):
        self.images.append((tag, np.asarray(value), step))

    add_image = add_images

    def close(self):
        pass


def render_counts(side_h, side_w, levels):
    """Launches of each render kernel for one frame: levels x chunks."""
    return levels * -(-side_h * side_w // CHUNK)


def check_render_launches(counts, want, where):
    """Raise unless each render kernel launched `want` times and no other
    kernel ran."""
    bad = {k: v for k, v in counts.items()
           if v != (want if k in RENDER_KERNELS else 0)}
    if bad:
        raise AssertionError(f'{where}: expected {want} launches of each '
                             f'render kernel and nothing else, got {bad}')


def multiscale_run(hp0, dev, root):
    """Phase 7b: a multi-scale Blender run through the command lines, the
    scene written under `root`; -> (the checkpoint directory, {path: launch
    counts})."""
    levels = hp0['nerf.num_levels']
    paths = {}
    t0 = time.perf_counter()
    blender = os.path.join(root, 'blender')
    make_sphere_scene(os.path.join(blender, 'sphere'), size=MS_SIDE,
                      **MS_VIEWS)
    convert_cli.main(['--blender_dir', blender, '--out_dir',
                      os.path.join(root, 'multi'), '--n_down',
                      str(MS_LEVELS)])
    data = os.path.join(root, 'multi', 'sphere')
    with open(os.path.join(data, 'metadata.json')) as f:
        sizes = sorted({int(w) for w in json.load(f)['train']['width']},
                       reverse=True)
    log(f'[multi] make_sphere_scene {MS_VIEWS} of {MS_SIDE}x{MS_SIDE}, '
        f'cli.convert --n_down {MS_LEVELS}: levels {sizes} in '
        f'{time.perf_counter() - t0:.1f} s')
    if sizes != [MS_SIDE >> i for i in range(MS_LEVELS)]:
        raise AssertionError(f'the pyramid has levels {sizes}')

    out = os.path.join(root, 'out')
    writer = RecordingWriter()
    make_writer = system_mod._summary_writer
    system_mod._summary_writer = lambda logdir: writer
    km.reset_launches()
    try:
        system, state = train_cli.main([
            '--data_path', data, '--out_dir', out, '--dataset_name',
            'multi_blender', '--max_steps', str(RUN_STEPS), 'exp_name',
            'multi', 'nerf.mlp_backend', 'pallas_lean_save',
            'train.batch_size', str(TRAIN_RAYS), 'train.steps_per_call',
            str(RUN_K), 'val.check_interval', str(RUN_VAL), 'val.sample_num',
            '1', 'optimizer.lr_delay_steps', '0'])
    finally:
        system_mod._summary_writer = make_writer
    counts = paths['multiscale_train'] = dict(km.launches)
    hp = system.hparams
    stats = system.fit_stats
    # Validation renders val entries 0 (the sanity frame and step 20) and
    # 1 (step 40): levels 200 and 100 of the first view.
    val = system.val_dataset
    frames = [val.camera(i)[1] for i in (0, 0, 1)]
    want_render = sum(render_counts(h, w, levels) for h, w in frames)
    # The training forward projects the view rows through lean_view_proj
    # too.
    want = {'lean_save_fwd': levels * RUN_STEPS,
            'lean_param_grads': levels * RUN_STEPS,
            **{k: want_render for k in RENDER_KERNELS}}
    want['lean_view_proj'] += levels * RUN_STEPS
    log(f'[multi] cli.train --dataset_name multi_blender, {RUN_STEPS} steps '
        f'of {TRAIN_RAYS} rays, f32 pallas_lean_save: loss '
        f'{stats["loss_first"]:.5f} at step {RUN_K} -> '
        f'{stats["loss_last"]:.5f} at step {RUN_STEPS}; '
        f'{stats["rays_per_sec"]:,.0f} rays/s over the training time; the '
        f'loop waited on the batcher for '
        f'{100 * stats["data_wait_share"]:.2f} % of its '
        f'{stats["loop_seconds"]:.2f} s; launches '
        f'{ {k: v for k, v in counts.items() if v} }')
    if any(counts[k] != want.get(k, 0) for k in counts):
        raise AssertionError(f'the run launched {counts}, expected {want} '
                             'and nothing else')
    check_routes(hp, torch.float32, 'phase 7b run',
                 lean_save_fwd=levels * RUN_STEPS, lean_mlp=want_render)
    check_chain_routes(hp, torch.float32, 'phase 7b run',
                       lean_param_grads=levels * RUN_STEPS)
    check_wgrad_routes(hp, torch.float32, 'phase 7b run',
                       lean_param_grads=levels * RUN_STEPS)
    if state['step'] != RUN_STEPS or not (
            np.isfinite(stats['loss_last'])
            and stats['loss_last'] < stats['loss_first']):
        raise AssertionError(f'the multi-scale loss did not fall: {stats}')
    # The first image's panels at each validation (steps 20 and 40).
    panels = [(tag, v.shape, step) for tag, v, step in writer.images]
    want_panels = []
    for step, (h, w) in zip((RUN_VAL, RUN_STEPS), frames[1:]):
        want_panels += [('val/GT_coarse_fine', (3, 3, h, w), step),
                        ('distance', (3, h, w), step)]
    log(f'[multi] validation panels {panels}')
    if panels != want_panels or not all(np.all(np.isfinite(v))
                                        for _, v, _ in writer.images):
        raise AssertionError(f'the panels are {panels}, expected '
                             f'{want_panels}, finite')

    ckpt_dir = os.path.join(out, 'ckpt', 'multi')
    km.reset_launches()
    summary = eval_cli.main(['--ckpt', ckpt_dir, '--out_dir', out,
                             '--scale', str(MS_LEVELS), '--base_size',
                             str(MS_SIDE), str(MS_SIDE), '--save_image',
                             '--chunk_size', str(CHUNK)])
    counts = paths['multiscale_eval'] = dict(km.launches)
    test_dir = os.path.join(out, 'test', 'multi')
    with open(os.path.join(test_dir, 'psnrs.txt')) as f:
        psnrs = [float(v) for v in f.read().split()]
    buckets = sorted(d for d in os.listdir(test_dir)
                     if os.path.isdir(os.path.join(test_dir, d)))
    movs = {d: [os.path.getsize(os.path.join(test_dir, d, m))
                for m in os.listdir(os.path.join(test_dir, d))
                if m.endswith('.mov')] for d in buckets}
    columns = [part.split() for part in summary.split(' | ')]
    n_test = MS_VIEWS['n_test']
    want_render = n_test * sum(render_counts(s, s, levels)
                               for s in sizes)
    log(f'[multi] cli.eval --scale {MS_LEVELS} --base_size {MS_SIDE} '
        f'{MS_SIDE} --save_image: psnrs {np.round(psnrs, 3).tolist()}; '
        f'buckets {buckets}, .mov bytes {movs}; summary {summary}; '
        f'launches { {k: v for k, v in counts.items() if v} }')
    check_render_launches(counts, want_render, 'phase 7b eval')
    if (len(psnrs) != n_test * MS_LEVELS or not np.all(np.isfinite(psnrs))
            or buckets != sorted(str(2 ** i) for i in range(MS_LEVELS))
            or any(len(v) != 1 or v[0] == 0 for v in movs.values())
            or [len(c) for c in columns] != [MS_LEVELS, MS_LEVELS, 1]):
        raise AssertionError('eval did not write the multi-scale buckets')

    # The checkpoint's test frames through the kernel path against the
    # plain path on the card.
    hp = load_hparams(ckpt_dir)
    _, params = restore_for_eval(ckpt_dir)
    params = {k: v.to(dev) for k, v in params['params'].items()}
    kernel_sys = MipNeRFSystem(hp, device=dev)
    plain_sys = MipNeRFSystem(dict(hp, **{'val.mlp_backend': 'xla'}),
                              device=dev)
    test = make_dataset(hp, 'multi_blender', data, 'test')
    for index in MS_FRAMES:
        cam, (h, w) = test.camera(index)
        km.reset_launches()
        got = kernel_sys.render_camera(params, cam, h, w, chunk_size=CHUNK,
                                       need_coarse=False)
        check_render_launches(dict(km.launches),
                              render_counts(h, w, levels),
                              f'phase 7b {h}x{w} frame')
        ref = plain_sys.render_camera(params, cam, h, w, chunk_size=CHUNK,
                                      need_coarse=False)
        d_rgb = float(np.abs(got['fine_rgb'] - ref['fine_rgb']).max())
        d_acc = float(np.abs(got['acc'] - ref['acc']).max())
        log(f'[multi] test entry {index} ({h}x{w}, {h * w} rays): kernel vs '
            f'plain max|d rgb| {d_rgb:.3e} max|d acc| {d_acc:.3e} (bar '
            f'{FRAME_BAR})')
        if d_rgb > FRAME_BAR or d_acc > FRAME_BAR or not all(
                np.all(np.isfinite(v)) for v in got.values()):
            raise AssertionError(f'the {h}x{w} frame disagrees with the '
                                 'plain path')
    return ckpt_dir, paths


def orbit_video(hp0, ckpt_dir, root):
    """Phase 7c: cli.render_video from the multi-scale checkpoint; -> its
    launch counts."""
    levels = hp0['nerf.num_levels']
    out = os.path.join(root, 'video')
    km.reset_launches()
    seconds = video_cli.main(['--ckpt', ckpt_dir, '--out_dir', out,
                              '--scale', str(VIDEO_SCALES), '--base_size',
                              str(MS_SIDE), str(MS_SIDE), '--n_poses',
                              str(VIDEO_POSES), '--chunk_size', str(CHUNK)])
    counts = dict(km.launches)
    video_dir = os.path.join(out, 'render_spheric', 'multi')
    frames, movs = {}, {}
    for i in range(VIDEO_SCALES):
        d = os.path.join(video_dir, str(2 ** i))
        frames[2 ** i] = len([f for f in os.listdir(d)
                              if f.endswith('_rgb.png')])
        movs[2 ** i] = [os.path.getsize(os.path.join(d, f))
                        for f in os.listdir(d) if f.endswith('.mov')]
    want = VIDEO_POSES * sum(render_counts(MS_SIDE >> i, MS_SIDE >> i,
                                           levels)
                             for i in range(VIDEO_SCALES))
    per_frame = {k: f'{np.mean(v):.4f}' for k, v in seconds.items()}
    log(f'[video] cli.render_video --scale {VIDEO_SCALES} --base_size '
        f'{MS_SIDE} {MS_SIDE} --n_poses {VIDEO_POSES}: frames {frames}, '
        f'.mov bytes {movs}; s/frame by level (width divisor) {per_frame}; '
        f'launches { {k: v for k, v in counts.items() if v} }')
    check_render_launches(counts, want, 'phase 7c')
    if (frames != {2 ** i: VIDEO_POSES for i in range(VIDEO_SCALES)}
            or any(len(v) != 1 or v[0] == 0 for v in movs.values())):
        raise AssertionError('render_video did not write its frames and '
                             'videos')
    return counts


def benches(hp0):
    """Phase 7d: the port's bench with its defaults and render_bench at
    800x800 in f32 and bf16, in this process; -> {path: launch counts}."""
    import contextlib
    import io
    levels = hp0['nerf.num_levels']
    paths = {}
    km.reset_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench_mod.main([])
    counts = paths['bench'] = dict(km.launches)
    lines = [json.loads(x) for x in buf.getvalue().splitlines()
             if x.startswith('{')]
    for line in lines:
        log(f'[bench] {json.dumps(line)}')
    k = int(os.environ.get('BENCH_K', '100'))
    steps = 1 + (bench_mod.WARMUP_CALLS + bench_mod.N_CALLS) * k
    want = {name: levels * steps for name in ('lean_view_proj',
                                              'lean_save_fwd',
                                              'lean_param_grads')}
    log(f'[bench] launches { {n: v for n, v in counts.items() if v} } '
        f'(want {want})')
    keys = {'metric', 'value', 'unit', 'ms_per_step', 'backend'}
    if (rc != 0 or len(lines) != 2
            or [x['backend'] for x in lines] != ['xla', 'pallas_lean_save']
            or any(not keys <= set(x) for x in lines)
            or not lines[-1]['parity_ok']
            or lines[-1]['parity_max_leaf_rel_err'] > BF16_BAR
            or any(counts[n] != want.get(n, 0) for n in counts)):
        raise AssertionError(f'the bench failed: rc {rc}, lines {lines}')
    check_routes(hp0, torch.bfloat16, 'phase 7d bench',
                 lean_save_fwd=levels * steps)
    frames = render_bench_mod.WARMUP_FRAMES + render_bench_mod.TIMED_FRAMES
    for dtype in ('float32', 'bfloat16'):
        km.reset_launches()
        with contextlib.redirect_stdout(io.StringIO()):
            line = render_bench_mod.main(['--side', str(FULL_SIDE),
                                          'train.compute_dtype', dtype])
        counts = paths[f'render_bench_{dtype}'] = dict(km.launches)
        log(f'[render_bench] {json.dumps(line)}; launches '
            f'{ {n: v for n, v in counts.items() if v} }')
        frame = frames * levels * -(-FULL_SIDE ** 2 // line['chunk'])
        check_render_launches(counts, frame, f'phase 7d render_bench {dtype}')
        if not np.isfinite(line['sec_per_frame']):
            raise AssertionError(f'render_bench {dtype}: {line}')
    return paths


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; this run needs an NVIDIA GPU',
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda')
    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    log(f'[device] {kind} x{torch.cuda.device_count()}  torch '
        f'{torch.__version__} cuda {torch.version.cuda}')
    log(f'[device] nvidia-smi: {smi}')

    t0 = time.perf_counter()
    recs = _build.build_all(['lean_render', 'lean_train', 'ipe', 'tp_pair'])
    log(f'[build] nvcc {" ".join(_build.ARCH_FLAGS)}, in parallel: '
        f'{time.perf_counter() - t0:.1f} s')
    for name, rec in recs.items():
        _build.load(name)
        log(f'[build] {rec["so"].name} in {rec["seconds"]:.1f} s')
        for kernel, spill, regs in kernel_resources(rec['log']):
            log(f'[build]   {kernel}: {spill}; {regs}')
    # The wgmma kernels' dynamic shared memory (the lego chain's Cg, the
    # lego widths of the forward).
    smem = (ctypes.c_int * 2)()
    train_lib = _build.load('lean_train')
    train_lib.lean_sm90_smem(lego_cg(config.default()), smem)
    log(f'[build]   dynamic shared memory: lean_chain_sm90_kernel '
        f'{smem[0]} B, wgrad_sm90_kernel {smem[1]} B, lean_fwd_sm90_kernel '
        f'{train_lib.lean_fwd_sm90_smem(256, 128, 96)} B, '
        f'lean_fwd_tf32_kernel {train_lib.lean_fwd_tf32_smem(256, 128, 96)} '
        f'B, lean_chain_tf32_kernel '
        f'{train_lib.lean_chain_tf32_smem(256, 128, 8, 1)} B, '
        f'wgrad_tf32_kernel {train_lib.lean_wgrad_tf32_smem()} B (of 232448)')

    hp = config.default()
    system = MipNeRFSystem(hp, device=dev)
    if not system.eval_model._fused_render:
        raise AssertionError('val.mlp_backend=auto did not select the fused '
                             'lean-render path for the lego schema')
    params = jax_params_to_torch(flax_tree(system, seed=0), device=dev)

    results = compare_kernels(params, hp, dev)

    # Phase 4: the slice.
    cam = blender_camera(SIDE, dev)
    render_frame(system, params, cam)               # warm-up
    km.reset_launches()
    out, s_kernel = render_frame(system, params, cam)
    counts = dict(km.launches)
    n_chunks = -(-SIDE * SIDE // CHUNK)
    want = hp['nerf.num_levels'] * n_chunks
    log(f'[slice] render_camera {SIDE}x{SIDE}, chunk {CHUNK} '
        f'({n_chunks} chunks x {hp["nerf.num_levels"]} levels): '
        f'{s_kernel:.3f} s/frame; launches {counts}')
    if any(counts[k] != (want if k in RENDER_KERNELS else 0)
           for k in counts):
        raise AssertionError(f'expected {want} launches of every render '
                             f'kernel, got {counts}')
    check_routes(hp, torch.float32, 'phase 4 f32 frame', lean_mlp=want)
    for k, v in out.items():
        shape = (SIDE, SIDE, 3) if k.endswith('rgb') else (SIDE, SIDE)
        if v.shape != shape or not np.all(np.isfinite(v)):
            raise AssertionError(f'{k}: shape {v.shape} or non-finite')

    hp_plain = dict(hp, **{'val.mlp_backend': 'xla'})
    plain_system = MipNeRFSystem(hp_plain, device=dev)
    render_frame(plain_system, params, cam)
    km.reset_launches()
    ref, s_plain = render_frame(plain_system, params, cam)
    if any(km.launches.values()):
        raise AssertionError(f'plain path launched kernels: {km.launches}')
    d_rgb = float(np.abs(out['fine_rgb'] - ref['fine_rgb']).max())
    d_acc = float(np.abs(out['acc'] - ref['acc']).max())
    d_dist = float(np.abs(out['distance'] - ref['distance']).max())
    log(f'[slice] plain path: {s_plain:.3f} s/frame; kernel vs plain '
        f'max|d rgb| {d_rgb:.3e} max|d acc| {d_acc:.3e} (bar {FRAME_BAR}) '
        f'max|d distance| {d_dist:.3e}; mean rgb '
        f'{float(out["fine_rgb"].mean()):.4f} mean acc '
        f'{float(out["acc"].mean()):.4f}')
    if d_rgb > FRAME_BAR or d_acc > FRAME_BAR:
        raise AssertionError('kernel frame disagrees with the plain path')

    # The same frame in bf16: lean_mlp on the wgmma forward, 2 x 5
    # launches, against the f32 plain frame at the bf16 bar.
    bf_system = MipNeRFSystem(dict(hp, **{'train.compute_dtype': 'bfloat16'}),
                              device=dev)
    render_frame(bf_system, params, cam)
    km.reset_launches()
    out_b, s_bf16 = render_frame(bf_system, params, cam)
    counts_b = dict(km.launches)
    check_routes(hp, torch.bfloat16, 'phase 4 bf16 frame', lean_mlp=want)
    d_rgb = float(np.abs(out_b['fine_rgb'] - ref['fine_rgb']).max())
    d_acc = float(np.abs(out_b['acc'] - ref['acc']).max())
    log(f'[slice] bf16: {s_bf16:.3f} s/frame; launches {counts_b}; vs the '
        f'f32 plain frame max|d rgb| {d_rgb:.3e} max|d acc| {d_acc:.3e} '
        f'(bar {BF16_BAR})')
    if any(counts_b[k] != (want if k in RENDER_KERNELS else 0)
           for k in counts_b):
        raise AssertionError(f'bf16 frame: expected {want} launches of every '
                             f'render kernel, got {counts_b}')
    if d_rgb > BF16_BAR or d_acc > BF16_BAR or not all(
            np.all(np.isfinite(v)) for v in out_b.values()):
        raise AssertionError('the bf16 frame disagrees with the plain path')
    del bf_system

    # The same frame through fused_mlp's forward (val.mlp_backend pallas).
    pallas_system = MipNeRFSystem(dict(hp, **{'val.mlp_backend': 'pallas'}),
                                  device=dev)
    render_frame(pallas_system, params, cam)
    km.reset_launches()
    out_p, s_pallas = render_frame(pallas_system, params, cam)
    counts_p = dict(km.launches)
    d_rgb = float(np.abs(out_p['fine_rgb'] - ref['fine_rgb']).max())
    d_acc = float(np.abs(out_p['acc'] - ref['acc']).max())
    log(f'[slice] val.mlp_backend pallas: {s_pallas:.3f} s/frame; launches '
        f'{ {k: v for k, v in counts_p.items() if v} }; vs plain max|d rgb| '
        f'{d_rgb:.3e} max|d acc| {d_acc:.3e} (bar {FRAME_BAR})')
    if any(counts_p[k] != (want if k == 'mlp_fwd' else 0) for k in counts_p):
        raise AssertionError(f'expected {want} launches of mlp_fwd alone, got'
                             f' {counts_p}')
    if d_rgb > FRAME_BAR or d_acc > FRAME_BAR or not all(
            np.all(np.isfinite(v)) for v in out_p.values()):
        raise AssertionError('the pallas frame disagrees with the plain path')
    del pallas_system

    # The same frame with nerf.ipe_backend pallas: val.mlp_backend auto then
    # renders through the plain MLP, the encode through ipe_fwd.
    ipe_system = MipNeRFSystem(dict(hp, **_IPE), device=dev)
    if ipe_system.eval_model.mlp_backend != 'xla':
        raise AssertionError('ipe_backend pallas kept a fused render backend')
    render_frame(ipe_system, params, cam)
    km.reset_launches()
    out_i, s_ipe = render_frame(ipe_system, params, cam)
    counts_i = dict(km.launches)
    d_rgb = float(np.abs(out_i['fine_rgb'] - ref['fine_rgb']).max())
    d_acc = float(np.abs(out_i['acc'] - ref['acc']).max())
    log(f'[slice] nerf.ipe_backend pallas: {s_ipe:.3f} s/frame; launches '
        f'{ {k: v for k, v in counts_i.items() if v} }; vs the plain frame '
        f'on the default encode max|d rgb| {d_rgb:.3e} max|d acc| '
        f'{d_acc:.3e} (bar {FRAME_BAR})')
    if any(counts_i[k] != (want if k == 'ipe_fwd' else 0) for k in counts_i):
        raise AssertionError(f'expected {want} launches of ipe_fwd alone, got'
                             f' {counts_i}')
    if d_rgb > FRAME_BAR or d_acc > FRAME_BAR or not all(
            np.all(np.isfinite(v)) for v in out_i.values()):
        raise AssertionError('the ipe_backend pallas frame disagrees with '
                             'the plain path')
    del ipe_system

    # Phases 5 and 6: the training kernels and the training slice.
    results.update(compare_train_kernels(params, hp, dev))
    results.update(compare_classic_kernels(params, hp, dev))
    # The same four kernels' instantiation for a model with no view layer.
    hp_nv = dict(hp, **_NO_VIEW)
    params_nv = jax_params_to_torch(
        flax_tree(MipNeRFSystem(hp_nv, device=dev), seed=0), device=dev)
    results.update(compare_classic_kernels(params_nv, hp_nv, dev,
                                           '[no view layer]'))
    results.update(compare_ipe_kernels(hp, dev))
    results.update(compare_pair_kernels(hp, dev))
    tp_counts = tp_slice(hp, params, dev)
    train_counts = train_slice(hp, params, dev)
    no_view_slice(hp_nv, params_nv, dev)
    run_counts = whole_run(hp)
    with tempfile.TemporaryDirectory() as root:
        ckpt_dir, new_paths = multiscale_run(hp, dev, root)
        new_paths['orbit_video'] = orbit_video(hp, ckpt_dir, root)
    new_paths.update(benches(hp))
    if '--measure' in sys.argv[1:]:
        measure(hp, params, dev)

    # Each kernel's f32 numbers (and under 'bf16' its bf16 ones, where it
    # has them) at its phase-3 or phase-5 shape, with its
    # launches on its path: the render kernels in phase 4's frame, each
    # training kernel in the first configuration of phase 6 that runs it,
    # the standalone IPE kernels in phase 7's first train call, the pair
    # kernels in the TP slice's first run (net_width 1024, bf16: one
    # forward and one backward).
    kernels = []
    for name, (source, replaces) in km.KERNELS.items():
        r = results[(name, 'f32')]
        if name in RENDER_KERNELS:
            path_counts = counts
        elif name in ('ipe_fwd', 'ipe_bwd'):
            path_counts = run_counts
        elif name in ('tp_pair_fwd', 'tp_pair_bwd'):
            path_counts = tp_counts
        else:
            path_counts = next(train_counts[label] for label, (_, _, names)
                               in TRAIN_CONFIGS.items() if name in names)
        kernels.append({'name': name, 'route': 'cuda', 'source': source,
                        'replaces': replaces, 'launches': path_counts[name],
                        'max_abs_err': r['err'], 'ms': r['ms'],
                        'plain_ms': r['plain_ms'], 'bound_ms': r['bound_ms'],
                        'bound_by': r['bound_by'],
                        'library_ms': r['library_ms']})
        kernels[-1]['share'] = r['bound_ms'] / r['ms']
        # The kernel's launches on the paths of phases 7b-7d.
        kernels[-1]['launches_new_paths'] = {
            path: c[name] for path, c in new_paths.items() if c[name]}
        rb = results.get((name, 'bf16'))
        if rb is not None:     # the compute dtype of the bf16 steps
            kernels[-1]['bf16'] = {k: rb[k] for k in (
                'err', 'ms', 'plain_ms', 'bound_ms', 'library_ms')}
            kernels[-1]['bf16']['share'] = rb['bound_ms'] / rb['ms']
            if name in km.routes and sm90_route(hp, torch.bfloat16):
                kernels[-1]['bf16']['kernel'] = 'lean_fwd_sm90_kernel'
                kernels[-1]['bf16']['source'] = \
                    'mipnerf_pl_tpu_torch/csrc/lean_fwd_sm90.cuh'
            if name in km.chain_routes and chain_route(hp, torch.bfloat16)[0]:
                kernels[-1]['bf16']['chain'] = 'lean_chain_sm90_kernel'
        # The f32 numbers' wgmma kernels (the line's own 'source' is the
        # library the wrapper launches, which holds them).
        if name in km.routes and tf32_route(hp, torch.float32):
            kernels[-1]['kernel'] = 'lean_fwd_tf32_kernel'
            kernels[-1]['kernel_source'] = \
                'mipnerf_pl_tpu_torch/csrc/lean_fwd_tf32.cuh'
        if name in km.chain_routes and chain_route(hp, torch.float32)[1]:
            kernels[-1]['chain'] = 'lean_chain_tf32_kernel'
            kernels[-1]['chain_source'] = \
                'mipnerf_pl_tpu_torch/csrc/lean_chain_tf32.cuh'
        if name in km.wgrad_tf32_routes and km.wgrad_tf32_route(
                torch.float32, name == 'lean_param_grads_hybrid',
                *lego_wgrad_range(hp)):
            kernels[-1]['wgrad'] = 'wgrad_tf32_kernel'
            kernels[-1]['wgrad_source'] = \
                'mipnerf_pl_tpu_torch/csrc/lean_wgrad_tf32.cuh'
        if 'wgrad' in r:
            kernels[-1]['wgrad_ms'] = r['wgrad']
    log(f'[done] wall {time.perf_counter() - START:.1f} s')
    print(json.dumps({'kernels': kernels}))
    print(smi_line())
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
