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
     and b0 apart) at the chunk's 8192 rays and a training level's 3072,
     and so for lean_composite (its own device time beside its bound);
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
     val.mlp_backend pallas (fused_mlp's forward, mlp_fwd, 2 x 5 launches,
     each on lean_fwd_tf32_kernel's classic form) against the same plain
     frame at the same bar, and in bf16 (each on lean_fwd_sm90_kernel's
     classic form) against it at the bf16 bar; then the frame with
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
     their dtype, checked in every form; the lean chains of lean_param_grads,
     of the recompute backward and of lean_param_grads_hybrid on
     lean_chain_sm90_kernel in bf16 and lean_chain_tf32_kernel in f32,
     `check_chain_routes`; the weight gradients of every backward, the
     classic ones, hybrid's and tp_pair_bwd included, on wgrad_tf32_kernel
     in f32 and wgrad_sm90_kernel in bf16, by the library's own counts,
     `check_wgrad_routes`; and the f32 weight gradients of
     lean_param_grads timed alone, their device time from a torch.profiler
     window, bound and share, beside torch.mm on the same products, the
     library's way to the same sums, in the same run, `wgrad_yardstick`);
     lean_param_grads fed the plain forward's stream in the compute dtype
     and lean_param_grads_hybrid its own plain forward's stream and raw
     heads (lean_hybrid_fwd, twice: two runs bit-equal), each against its
     plain version on the same stream, at bench.py's metric (largest leaf
     ||a - b|| / ||b||): <= 1e-4 f32, <= 3e-2 bf16, and hybrid's time
     printed beside lean_param_grads' and beside torch.mm on the same
     weight-gradient products (`mm_yardstick`); lean_param_grads_recompute
     against lean_param_grads on the kernel forward's stream (the same
     forward re-run chunk by chunk): <= 1e-5 in both dtypes, two runs equal
     bit for bit, and its peak memory below one level-sized saved stream;
     the same three forwards and the recompute backward on the level's
     [6, M] moments (`encode=`), in f32 also against the rows form on the
     plain decode of the same moments (<= 1e-5); lean_composite_bwd (both
     backgrounds; and its device time from a torch.profiler window) and
     ipe_moments at the level's shape (<= 1e-5, f32); the
     classic kernels of fused_mlp on the level with per-point view rows (the
     view repeated over the samples, as the model feeds them): mlp_save_fwd
     (outputs and stream) and mlp_fwd (bit for bit its outputs) at the
     phase-3 bars, mlp_bwd_saved on the plain forward's stream (dx, dview
     and every parameter at bench.py's metric, <= 1e-4 f32, <= 3e-2 bf16),
     mlp_bwd_recompute against mlp_bwd_saved on the kernel forward's stream
     (<= 1e-5, dx and dview bit for bit, two runs equal); the lego
     forwards (and the recompute re-runs) on the classic form of the wgmma
     forward of their dtype (lean_fwd_tf32_kernel, lean_fwd_sm90_kernel)
     and both backwards' chain, dx and dview on the wgmma chain's
     (lean_chain_tf32_kernel, lean_chain_sm90_kernel)
     (`check_classic_routes`); the same four
     kernels' instantiation for a model with no view layer
     (net_depth_condition 0: the rgb head reads concat(bottleneck, view)),
     the same checks at the same bars, on the NV forms of the wgmma
     kernels of each dtype (f32 lean_fwd_tf32_kernel and
     lean_chain_tf32_kernel, bf16 lean_fwd_sm90_kernel and
     lean_chain_sm90_kernel), as the rules say; and for the lego widths
     with two density heads, with a view layer and without (shapes the
     wgmma rules refuse), the same checks at the same bars on the classic
     MLP's mma.sync kernels, each form in both dtypes: mlp_fwd_kernel,
     lean_grad_chain_kernel and mlp_input_grads_kernel, by the library's
     own counts (CLASSIC_SHAPES); the standalone
     IPE kernels ipe_fwd and ipe_bwd on the level's Gaussians (393,216
     points, degrees 0..16), with their covariances and with them zeroed,
     on a ragged count, with the means pushed past |mean| 3.25 (every
     degree-15 argument past 105,615) and at degrees 16..32: forward max
     |d| <= 1e-5, dmeans and dcovs ||a - b|| / ||b|| <= 1e-5, two runs
     bit-equal, and both kernels' device times (torch.profiler) beside the
     events; the Megatron pair
     kernels tp_pair_fwd and tp_pair_bwd at the pair shapes of the level at
     net_width 1024 on a model axis of 2 and at 100,003 rows, on
     tp_pair_wg_kernel (wgmma + TMA, bf16 and 3xTF32), and the mma.sync
     pair kernels at a local width the wgmma rule refuses, each call's
     kernel asserted from the library's counts (check_pair_routes), with
     torch.mm on the same products as their yardstick
     (compare_pair_kernels);
     CUDA-event times of every kernel and its plain version, and each
     kernel's bound: the larger of its FLOP over the card's peak and its
     bytes over 3.35 TB/s (kernel_work);
  5b. the TP slice: tp_lean_forward on a single-process (data, model)
     mesh on the card, the lego level, net_width 1024 on 2 shards (model
     axis 2) and net_width 256 on 8 (model axis 4), bf16 and f32, forward
     and the gradient of a seeded linear loss against the full-width plain
     lean forward; tp_pair_fwd and tp_pair_bwd must launch 4 pairs x the
     shards times (8 and 8, then 32 and 32), all on tp_pair_wg_kernel of
     the dtype; ms of forward and of forward + backward and the peak memory
     beside the plain forward's (tp_slice);
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
     chain (pallas_hybrid's included) on the wgmma kernel of its dtype,
     every classic forward and chain on the wgmma classic forms of its
     dtype, every backward's weight gradients on wgrad_tf32_kernel in f32
     and wgrad_sm90_kernel in bf16, and the loss must stay finite;
     ms/step, rays/s and peak memory of every configuration and of the
     plain path, in turns (plain, each configuration, then back, twice:
     best, median and spread of the 4 runs); past
     F32_TURNS_BY seconds the new configurations' f32 turns are cut, never
     a gate; one f32 gate of pallas_lean with density_noise 1.0, whose
     kernels return raw heads (act=None); and each model of
     CLASSIC_SHAPES on pallas_save and pallas with stop_resample_grad
     False, bf16 and f32: the gate, then K = 5 steps (mlp_save_fwd and
     mlp_bwd_saved, or mlp_fwd and mlp_bwd_recompute, 2 x 5 launches; with
     no view layer on the NV forms of the wgmma kernels of each dtype, with
     two density heads on the mma.sync kernels, check_classic_routes);
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
  8a. the unbounded-360 kernels at full width: configs/real360.yaml (8x256,
     view 128, 128 + 128 samples) with seeded weights, a training level of
     3072 seeded 360 rays (origins on the radius-4 sphere, near 2.5, far
     5.5, t_inv samples) whose x rows are the icosahedral IPE, F = 42:
     lean_save_fwd (#3) and lean_param_grads (#4a) against their plain
     versions at the phase-3 / phase-5 bars, f32 and bf16, on the wgmma
     kernels of each dtype (check_routes, check_chain_routes,
     check_wgrad_routes: 42 rounds up to the forwards' slabs), each
     gradient leaf of trunk_0's and the skip layer's shapes;
  8b. the real360 gradient gate: one training step of the real360 system on
     pallas_lean_save against the plain path on the same rays and
     generator seed, bf16 (3e-2) and f32 (2e-3), then with
     nerf.fuse_render (the render-fused level, #1 / #2, compositing over
     1/t_inv); each step launches lean_save_fwd, lean_view_proj and
     lean_param_grads once a level (and with fuse_render lean_composite and
     lean_composite_bwd) and nothing else, on the routes of its dtype;
  8c. the real360 run through the command lines: make_llff_sphere_capture
     writes 24 views of 256x256 (21 train: 1,376,256 rays) into a
     temporary directory; cli.train --dataset_name real360 --config
     configs/real360.yaml (bf16, pallas_lean_save, data.factor 1,
     lr_delay_steps 0) for 200 steps in dispatches of 50 with one
     validation: the loss falls and is finite, lean_save_fwd,
     lean_view_proj and lean_param_grads launch 2 a step and nothing else
     runs (validation renders on the plain path, as JAX's unbounded eval
     does), best/ and last/ hold step 200; cli.eval --white_bkgd False (no
     launch): 3 finite PSNR / SSIM values; the run's rays/s and batcher-wait
     share;
  8d. tools.quality_smoke --steps 3000 in bf16 on pallas_lean_save (the JAX
     tool's settings): val PSNR >= 27.0 dB, lean_save_fwd and
     lean_param_grads 2 a step; its PSNR, wall time and rays/s beside the
     card's nvidia-smi line;
  8e. the multi-scale tools through the command lines, at the lego width of
     their defaults (8x256, 128 + 128 samples, 3072 rays) in bf16 with
     nerf.mlp_backend pallas_lean_save forwarded: tools.ablation (three
     arms: multi_ipe, multi_pe with nerf.disable_integration, single_ipe
     on the full-resolution scene), tools.distloss_ablation (two arms:
     loss.distloss_mult 0.01 and 0) and tools.acceptance (--scene hard),
     TOOLS_STEPS steps an arm on the hard scene of TOOLS_SIZE px, each
     evaluated on the same TOOLS_LEVELS-level pyramid (multi_ipe,
     distloss_on and the acceptance run are one configuration and seed,
     trained once as multi_ipe, whose checkpoint the other two evaluate
     with --skip_train); the stages (cli.
     convert, cli.train, cli.eval) run through their main in this process
     (tools/stages.py), each counted alone: every training stage launches
     lean_save_fwd and lean_param_grads 2 a step on the bf16 wgmma kernels
     (check_routes, check_chain_routes, check_wgrad_routes) and its
     validation renders through the kernels, multi_pe's models both run
     with zero covariances, every eval launches lean_view_proj, lean_mlp
     and lean_composite levels x chunks of each test entry (lean_mlp on the
     bf16 wgmma forward) and nothing else; the reports exist with finite
     per-scale PSNR and SSIM, each arm's average PSNR at or above its floor
     in TOOLS_MIN_PSNR, the sign checks printed (not gated at this length);
     then utils.visualize_cameras: export_html of the scene's cameras, its
     pyramid's and the orbit, and the PNG where matplotlib imports (the
     line says which ran).  Phase 7 also asserts that its batches came
     through the native gather (mipnerf_pl_tpu_torch/native/gather.cpp,
     built with g++ in the batcher's set-up), every field in its one pass,
     and prints the batcher-wait share and the host ms of the library's
     gather of a K x 3072-row draw beside numpy indexing's;
  9. data parallelism through the system, at lego width on
     pallas_lean_save with train.randomized True: 9a, the single-process
     mesh of 2 shards on the card against data 1, one step from the same
     parameters, batch and step generator, f32 and bf16: the loss (f32
     within 1e-6 relative), the largest leaf rel err of the parameter
     update and of the gradients (2e-3 f32, 3e-2 bf16), lean_save_fwd and
     lean_param_grads 2 levels x 2 shards a step on the wgmma kernels of
     the dtype; ms/step of data 2 beside data 1 in turns; 9b, 2 processes
     on the one card over gloo (NCCL takes no two ranks on one device),
     each fit() of 50 bf16 steps on a 64x64 sphere scene with one
     validation and one checkpoint: final parameters bit-equal across the
     ranks and within 3e-2 of a single-process data-2 fit, the loss falls,
     rank 0 alone wrote the checkpoint, the CSV row and the log lines, the
     sharded render of val view 0 within 1e-3 of the data-1 render of the
     same parameters; rays/s and the gradients' all-reduce share of the
     step.  The workers load the libraries phase 2 built;
  9c. tensor parallelism through the system at lego width on
     pallas_lean_save with train.randomized True, f32 and bf16: the
     single-process meshes data 1 x model 2 and data 2 x model 2 on the
     card against data 1 x model 1, one step from the same parameters,
     batch and step generator: the loss (f32 within 1e-5 relative), the
     largest leaf rel err of the gradients (2e-3 f32, 3e-2 bf16), and of
     the update of data 2 x model 2 against data 1 x model 2 (against
     model 1 the update is printed: Adam's first step is ~ lr sign(g), and
     two kernel paths' roundings flip the signs of gradients near zero);
     tp_pair_fwd and tp_pair_bwd 16 and 16 a step at model 2
     (4 pairs x 2 ranks x 2 levels), 32 and 32 at data 2 x model 2, on the
     tp_pair_wg_kernel of the dtype (its route counts), and no other kernel
     (lean_save_fwd / lean_param_grads 0); an 'xla' step at data 1 x model
     2 launches nothing and passes the same gate against 'xla' at model 1;
     ms/step and peak GiB of 5-step calls beside model 1, in turns;
  9d. net_width 1024 (condition 128, BENCH_NET_WIDTH=1024's model) in bf16:
     one step at data 1 x model 2 against 'xla' at model 1, the gradients
     at the bf16 bar, the pairs at a local width of 512 (16 + 16 on
     tp_pair_wg_kernel<bf16>); ms/step and peak GiB of both;
  9e. cli.train over 2 gloo processes on the one card (num_devices 2
     parallel.model_axis 2; chip_smoke.py --tp-worker joins the group as
     9b's workers do, then runs cli.train's main), 50 bf16 steps of 384
     rays on 9b's scene with one validation and one checkpoint (the rays
     cut from 3072: every pair boundary all-reduces the [rows, 256]
     activations, which gloo stages through the host, ~7 s a step at 3072
     rays on an H100, PERF.md); each process holds its panels of the
     parameters and Adam moments: their bytes, counted from the tensors,
     equal the split's table's count (0.524 of the whole state), printed
     with torch.cuda.memory_allocated after the state's set-up; the
     checkpoint holds whole tensors, of which each rank's parameters are
     its panels bit for bit; within 3e-2 of the single-process data 1 x
     model 2 fit, the loss falls, rank 0 alone wrote the files, log lines
     and the system's line, the pairs 400 + 400 a rank on their route and
     no lean training kernel; a 5-step resume over 2 processes from the
     checkpoint (each slicing its panels of the parameters and both
     moments) within 3e-2 of the unbroken single-process state going on
     over the same 5 steps; then cli.eval of the checkpoint in one process
     (its model axis dropped): finite PSNR and SSIM;
  9f. the model shapes the Megatron pairs alone do not take (an odd
     depth 7, skip_index 3: a skip at a pair boundary, net_depth_condition
     0, use_viewdirs False), each one pallas_lean_save step at data 1 x
     model 2 against 'xla' at model 1 from the same parameters, batch and
     generator: bf16 at net_width 1024 (9d's model), the gradients at
     3e-2; f32 at lego width, the loss within 1e-5 relative and the
     gradients at 2e-3; the update printed; tp_pair_fwd / tp_pair_bwd
     once a pair, rank and level, every pair (the boundary pair of f_in =
     W + F too) on the tp_pair_wg_kernel of the dtype by the route counts;
     ms/step and peak GiB of each shape, and the phase's seconds;
  10. the kernels' JSON line (launches, error, times, bound, library call;
     each kernel's launches on the paths of phases 7b-7d under
     `launches_new_paths`, in phase 9 under `launches_dp`, in phases
     9c-9f under `launches_tp` and in phase 8e's stages under
     `launches_tools`;
     for the lean forwards and backwards also the wgmma kernel that runs
     them, f32 `kernel` / `chain` / `wgrad` and bf16 under 'bf16'; for f32
     lean_param_grads also its weight gradients' own ms, bound and
     torch.mm's ms under `wgrad_ms`; for fused_mlp's four kernels also
     their numbers for each model of CLASSIC_SHAPES under its key
     (`no_view`, `nd2`, `nd2_no_view`): ms, plain_ms, bound_ms, share, the
     kernels that ran them and phase 6's f32 launches, bf16 (with phase
     6's bf16 launches) under its 'bf16'; for lean_save_fwd and
     lean_param_grads also phase 8a's numbers at F = 42 under 'real360',
     with their launches in phase 8c's run),
     the script's wall time, the card's name and power limit, and last the
     line {"ok": true, "device": {...}}.

    python3 chip_smoke.py --measure

adds, before phase 10, the frame times at 800x800 (kernel and plain paths,
f32 and bf16, in turns k p p k), a torch.profiler table of one 200x200
kernel-path frame, and, with the host's issue time of an unprofiled step,
one of a bf16 train step of each lean backend, of pallas_lean_save with
fuse_render + fuse_encode and of pallas and pallas_save, and of an f32
step of the fused one and of pallas_lean_save.

It imports torch, numpy and the port; never JAX.  With no CUDA device it
exits non-zero before printing any result.
"""

import contextlib
import ctypes
import io
import json
import os
import shutil
import socket
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
                                                 make_llff_sphere_capture,
                                                 make_sphere_scene,
                                                 render_sphere_view)
from mipnerf_pl_tpu_torch.kernels import _build
from mipnerf_pl_tpu_torch.kernels import ipe as ki
from mipnerf_pl_tpu_torch.kernels import mlp as km
from mipnerf_pl_tpu_torch.kernels import tp_lean as kt
from mipnerf_pl_tpu_torch.models.mlp import LEAN_BACKENDS
from mipnerf_pl_tpu_torch.ops.camera import Camera, pix2cam_from_focal
from mipnerf_pl_tpu_torch.ops.math import (cast_rays_cmajor,
                                           integrated_pos_enc,
                                           integrated_pos_enc_360, pos_enc)
from mipnerf_pl_tpu_torch.ops.render import delta_mids
from mipnerf_pl_tpu_torch.ops.sampling import (sample_along_rays,
                                               sample_along_rays_360)
from mipnerf_pl_tpu_torch.parallel.mesh import (Mesh, create_mesh,
                                                maybe_initialize_distributed)
from mipnerf_pl_tpu_torch.rays import Rays
from mipnerf_pl_tpu_torch.system import MipNeRFSystem, make_dataset
from mipnerf_pl_tpu_torch.native import gather as native_gather
from mipnerf_pl_tpu_torch.tools import (ablation, acceptance,
                                        distloss_ablation, quality_smoke,
                                        stages)
from mipnerf_pl_tpu_torch.train.ckpt import (CheckpointManager, load_hparams,
                                            restore_for_eval)
from mipnerf_pl_tpu_torch.utils import visualize_cameras
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
GATHER_REPS = 50        # draws timed of the native gather and of numpy's
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
# (rows, f_in, local width, output width) of phase 5's mma.sync pair case: a
# local width the wgmma rule refuses (not a multiple of 64).
TP_MMA_SHAPE = (4097, 40, 272, 528)
_NO_VIEW = {'nerf.mlp.net_depth_condition': 0}
_NV_LABEL = '[no view layer]'     # phase 5's suffix of their kernels' names
# The lego widths with two density heads, with a view layer and without:
# shapes the wgmma rules refuse, so fused_mlp's kernels run on the classic
# MLP's mma.sync kernels (mlp_fwd_kernel, lean_grad_chain_kernel,
# mlp_input_grads_kernel), each form (NV or not) in both dtypes.  Key in
# the kernels line -> (hparams, phase 5's suffix).
_ND2 = {'nerf.mlp.num_density_channels': 2}
CLASSIC_SHAPES = {
    'no_view': (_NO_VIEW, _NV_LABEL),
    'nd2': (_ND2, '[two density heads]'),
    'nd2_no_view': ({**_ND2, **_NO_VIEW}, '[two density heads, no view layer]'),
}
# Phases 8a-8d: the unbounded-360 config (configs/real360.yaml at full
# width, F = 42 encode features) on pallas_lean_save, its kernels' suffix in
# the results, its whole run (a capture of REAL360_CAPTURE, REAL360_STEPS
# steps in dispatches of REAL360_K), and the quality smoke's steps and bar.
REAL360_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              'configs', 'real360.yaml')
REAL360_TAG = '[real360]'
REAL360_CAPTURE = {'size': 256, 'n_images': 24}
REAL360_STEPS, REAL360_K = 200, 50
QUALITY_STEPS, QUALITY_MIN_PSNR = 3000, 27.0
# Phase 8e: the multi-scale tools (tools/ablation.py, distloss_ablation.py,
# acceptance.py) at the lego width of their defaults, bf16, on
# pallas_lean_save, on the hard scene of TOOLS_SIZE px and its
# TOOLS_LEVELS-level pyramid, TOOLS_STEPS steps an arm; each arm's average
# PSNR over the scales must reach its floor in TOOLS_MIN_PSNR (2 dB under
# the first measurement on the card, PERF.md).
TOOLS_SIZE, TOOLS_LEVELS, TOOLS_STEPS = 64, 4, 1000
TOOLS_OPTS = ['nerf.mlp_backend', 'pallas_lean_save']
TOOLS_MIN_PSNR = {'multi_ipe': 14.6, 'multi_pe': 12.8, 'single_ipe': 12.1,
                  'distloss_on': 14.6, 'distloss_off': 14.6,
                  'acceptance_hard': 14.6}
# Phase 9: data parallelism through the system.  9a: the single-process
# mesh of DP_SHARDS shards against data 1, one step and DP_K-step timing
# turns; 9b: DP_SHARDS gloo processes on the one card, each fitting
# DP_STEPS steps in dispatches of DP_K on a sphere scene of DP_SCENE, each
# process given DP_TIMEOUT seconds.
DP_SHARDS, DP_K, DP_STEPS = 2, 5, 50
DP_SCENE = {'n_train': 8, 'n_val': 1, 'n_test': 1, 'size': 64}
DP_TIMEOUT = 300
# Phases 9c-9f: tensor parallelism through the system.  9c: the
# single-process meshes TP_SYSTEM_MESHES (data, model) against data 1 x
# model 1 at lego width; 9d: the width of TP_WIDE at model 2 against 'xla'
# at model 1; 9e: cli.train over 2 gloo processes (data 1 x model 2),
# TP_STEPS steps in dispatches of DP_K on phase 9b's scene.
TP_SYSTEM_MESHES = ((1, 2), (2, 2))
TP_WIDE = {'nerf.mlp.net_width': 1024, 'nerf.mlp.net_width_condition': 128}
TP_STEPS = 50
TP_RUN_RAYS = 384      # 9e's rays a step (see the docstring)
# Phase 9f: the model shapes the Megatron pairs alone do not take, each at
# data 1 x model 2 against 'xla' at model 1 (bf16 at TP_WIDE, f32 at lego
# width): an odd depth (the last layer alone), an odd skip index (a skip at
# a pair boundary after layer 3 and one inside a pair after layer 6), no view layer, no
# view directions.
TP_SHAPES = {'depth7': {'nerf.mlp.net_depth': 7},
             'skip3': {'nerf.mlp.skip_index': 3},
             'condition0': {'nerf.mlp.net_depth_condition': 0},
             'no-viewdirs': {'nerf.use_viewdirs': False}}
# What a lean save step launches, once a level and shard (the forward's
# view rows through lean_view_proj).
DP_STEP_KERNELS = _SAVE + ('lean_view_proj',)
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


def xyz_features(hp) -> int:
    """The encode's features a sample: 42 for the unbounded model's
    icosahedral IPE, 6 a degree otherwise."""
    if hp.get('nerf.unbounded'):
        return 42
    return 6 * (hp['nerf.max_deg_point'] - hp['nerf.min_deg_point'])


def layer_shapes(hp):
    """The (in, out) of hp's MLP kernels in param order."""
    depth = hp['nerf.mlp.net_depth']
    dcond = hp['nerf.mlp.net_depth_condition']
    skip = hp['nerf.mlp.skip_index']
    W = hp['nerf.mlp.net_width']
    Wv = hp['nerf.mlp.net_width_condition']
    F = xyz_features(hp)
    Fv = 3 * (2 * hp['nerf.deg_view'] + 1)
    shapes, d_in = [], F
    for i in range(depth):
        shapes.append((d_in, W))
        d_in = W + (F if i % skip == 0 and i > 0 else 0)
    shapes += [(d_in, hp['nerf.mlp.num_density_channels']), (d_in, W)]
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
    F = xyz_features(hp)
    Fv = 3 * (2 * hp['nerf.deg_view'] + 1)
    M, Mp = R * N, -(-R * N // km.TILE) * km.TILE
    es = 2 if tag == 'bf16' else 4
    Cs = km.saved_rows(F, W, Wv, depth, dcond)[-1]
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
    if name in ('lean_param_grads', 'lean_param_grads_hybrid'):
        return bwd, 0, Cs * Mp * es + Mp * 16 + g + view + params + grads
    if name == 'lean_param_grads_recompute':
        return fwd + bwd, decode, x_in + vproj + g + view + params + grads
    # The classic MLP of fused_mlp, as the JAX function's inputs and
    # outputs: x and the view f32 per point (view_0 on all of them), raw
    # heads; the backward's chain runs back to the inputs (every layer's
    # input cotangent, as many products as the forward) beside every weight
    # gradient, dx and dview out; the saved stream is the JAX set (hs,
    # bottleneck, ys) in the compute dtype.
    # With no view layer (net_depth_condition 0) layer_shapes has no view_0
    # and an rgb head of W + Fv rows, and the stream no ys rows.
    cfwd = 2 * M * n_w
    pts = M * (F + Fv) * 4
    g = M * (3 + hp['nerf.mlp.num_density_channels']) * 4
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
    F = xyz_features(hp)
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


# fused_mlp's wrappers: those whose forward (mlp_bwd_recompute: its re-run)
# and those whose chain, dx and dview may take the wgmma kernels.
CLASSIC_FWD = ('mlp_fwd', 'mlp_save_fwd', 'mlp_bwd_recompute')
CLASSIC_CHAIN = ('mlp_bwd_saved', 'mlp_bwd_recompute')


def classic_route(hp, dt):
    """(forward, chain): whether fused_mlp's forwards and backward chain of
    hp's MLP (its density heads, the 27 per-point view features) in dt take
    the wgmma classic forms of dt's kernels: f32 lean_fwd_tf32_kernel /
    lean_chain_tf32_kernel (kernels/mlp.py fwd_tf32_route /
    chain_tf32_route; with no view layer their NV forms), bf16
    lean_fwd_sm90_kernel / lean_chain_sm90_kernel (fwd_sm90_route /
    chain_sm90_route), with the classic arguments."""
    F, W, Wv, depth, dcond = _widths(hp)
    Fv = 3 * (2 * hp['nerf.deg_view'] + 1)
    nd = hp['nerf.mlp.num_density_channels']
    f32 = dt == torch.float32
    fwd = km.fwd_tf32_route if f32 else km.fwd_sm90_route
    chain = km.chain_tf32_route if f32 else km.chain_sm90_route
    return (fwd(dt, F, W, Wv, depth, dcond, Fv, nd),
            chain(dt, W, Wv, depth, dcond, F=F, Fv=Fv, nd=nd,
                  skip_index=hp['nerf.mlp.skip_index']))


def classic_kernel_names(name, hp, dt):
    """{'kernel': the forward's, 'chain': the chain's} device kernels of
    fused_mlp wrapper `name` for hp's MLP in dt (the forward of
    mlp_bwd_recompute: its re-run): the wgmma classic forms where
    classic_route says so, else the mma.sync kernels (the chain with
    mlp_input_grads_kernel after it); with no view layer their NV forms."""
    on = classic_route(hp, dt)
    (fwd, chain), _ = classic_kernels(dt)
    fwd, chain = (fwd if on[0] else 'mlp_fwd_kernel',
                  chain if on[1] else 'lean_grad_chain_kernel')
    if hp['nerf.mlp.net_depth_condition'] == 0:
        fwd, chain = fwd + ' (NV form)', chain + ' (NV form)'
    if not on[1]:
        chain += ' + mlp_input_grads_kernel'
    out = {}
    if name in CLASSIC_FWD:
        out['kernel'] = fwd
    if name in CLASSIC_CHAIN:
        out['chain'] = chain
    return out


def classic_kernels(dt):
    """The wgmma kernels (forward, chain) of fused_mlp's classic forms in
    dt, and the route counts that record each."""
    if dt == torch.float32:
        return (('lean_fwd_tf32_kernel', 'lean_chain_tf32_kernel'),
                (km.tf32_routes, km.chain_tf32_routes))
    return (('lean_fwd_sm90_kernel', 'lean_chain_sm90_kernel'),
            (km.routes, km.chain_routes))


def check_classic_routes(hp, dt, where, **calls):
    """Raise unless each named fused_mlp wrapper's `calls` since the last
    reset_launches ran its forward and its chain (with dx and dview) on the
    wgmma kernels of dt (classic_kernels) where classic_route says so, and
    elsewhere on the mma.sync kernels (the forward on mlp_fwd_kernel, the
    chain on lean_grad_chain_kernel, dx and dview on
    mlp_input_grads_kernel), all by the library's own counts, and never on
    the other dtype's wgmma kernels; the lego schema's classic kernels with
    one density head must take the wgmma forms in both dtypes, with a view
    layer and (their NV forms) without."""
    on = classic_route(hp, dt)
    if (hp['nerf.mlp.net_width'] == 256
            and hp['nerf.mlp.num_density_channels'] == 1 and not all(on)):
        nv = hp['nerf.mlp.net_depth_condition'] == 0
        raise AssertionError(f'the lego {dt} classic kernels'
                             f'{" with no view layer" if nv else ""} take '
                             f'no wgmma form: routes {on}')
    names, (fwd, chain) = classic_kernels(dt)
    _, (o_fwd, o_chain) = classic_kernels(
        torch.bfloat16 if dt == torch.float32 else torch.float32)
    got = {k: (fwd.get(k, 0), chain.get(k, 0), km.mma_fwd_routes.get(k, 0),
               km.mma_chain_routes.get(k, 0), km.mma_input_routes.get(k, 0),
               o_fwd.get(k, 0) + o_chain.get(k, 0)) for k in calls}
    want = {}
    for k, n in calls.items():
        f, c = n if k in CLASSIC_FWD else 0, n if k in CLASSIC_CHAIN else 0
        want[k] = (f if on[0] else 0, c if on[1] else 0, 0 if on[0] else f,
                   0 if on[1] else c, 0 if on[1] else c, 0)
    log(f'[route] {where}: classic calls on ({names[0]}, {names[1]}, '
        f'mlp_fwd_kernel, lean_grad_chain_kernel, mlp_input_grads_kernel, '
        f'the other dtype\'s wgmma kernels) {got} (want {want}) '
        f'{"OK" if got == want else "FAIL"}')
    if got != want:
        raise AssertionError(f'{where}: the classic kernels took another '
                             'route')


def lego_wgrad_range(hp, rays=TRAIN_RAYS):
    """(Mp, MC) of the lean backward at a training level of hp (of `rays`
    rays): its padded points and the points of one weight-gradient range
    (wgrad_split over its output tiles on this card)."""
    N = hp['nerf.num_samples']
    Mp = -(-rays * N // km.TILE) * km.TILE
    depth = hp['nerf.mlp.net_depth']
    dcond = hp['nerf.mlp.net_depth_condition']
    tiles = km.wgrad_problems(layer_shapes(hp), depth, dcond,
                              hp['nerf.mlp.skip_index'])[1]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return Mp, km.wgrad_split(Mp, len(tiles), N, sms)


def check_wgrad_routes(hp, dt, where, rays=TRAIN_RAYS, **calls):
    """Raise unless each named backward's `calls` since the last
    reset_launches ran their weight gradients on wgrad_tf32_kernel in f32
    (where wgrad_tf32_route says so, which at the lego level, and at a
    data shard's `rays` of it, it must) and on wgrad_sm90_kernel in bf16,
    by the library's own counts, and on no other kernel."""
    Mp, mc = lego_wgrad_range(hp, rays)
    f32 = dt == torch.float32
    on = km.wgrad_tf32_route(dt, Mp, mc)
    if f32 and not on:
        raise AssertionError('the lego f32 weight gradients take no wgmma '
                             'kernel')
    got = {k: (km.wgrad_tf32_routes[k], km.wgrad_sm90_routes[k])
           for k in calls}
    want = {k: (n if on else 0, 0 if f32 else n) for k, n in calls.items()}
    log(f'[route] {where}: weight gradients on (wgrad_tf32_kernel, '
        f'wgrad_sm90_kernel) {got} (want {want}) '
        f'{"OK" if got == want else "FAIL"}')
    if got != want:
        raise AssertionError(f'{where}: the weight gradients took another '
                             'route')


def pair_kernel(dt, f_in, Wl, Wout):
    """(index into (pair_sm90_routes, pair_tf32_routes, pair_mma_routes),
    device kernel) of the pair wrappers at these widths in dt: the bf16 or
    f32 form of tp_pair_wg_kernel where kernels/tp_lean.py pair_sm90_route
    / pair_tf32_route say so, else the mma.sync kernels."""
    if kt.pair_sm90_route(dt, f_in, Wl, Wout):
        return 0, 'tp_pair_wg_kernel<bf16>'
    if kt.pair_tf32_route(dt, f_in, Wl, Wout):
        return 1, 'tp_pair_wg_kernel<f32, 3xTF32>'
    return 2, 'tp_pair_fwd_kernel / tp_pair_bwd_kernel (mma.sync)'


def check_pair_routes(dt, where, dims, wgmma, **calls):
    """Raise unless each pair wrapper's `calls` since the last
    reset_launches ran (tp_pair_bwd: its chain) on the kernel pair_kernel
    names for dims = (f_in, Wl, Wout), by the library's own counts, and on
    no other; `wgmma`: the widths must take tp_pair_wg_kernel (the TP
    slice's), else the mma.sync kernels."""
    i, name = pair_kernel(dt, *dims)
    if (i < 2) != wgmma:
        raise AssertionError(f'{where}: widths {dims} in {dt} route to '
                             f'{name}')
    tables = (km.pair_sm90_routes, km.pair_tf32_routes, km.pair_mma_routes)
    got = {k: tuple(t[k] for t in tables) for k in calls}
    want = {k: tuple(n if j == i else 0 for j in range(3))
            for k, n in calls.items()}
    log(f'[route] {where}: pair calls on (tp_pair_wg_kernel bf16, '
        f'tp_pair_wg_kernel f32, mma.sync) {got} (want {want}: {name}) '
        f'{"OK" if got == want else "FAIL"}')
    if got != want:
        raise AssertionError(f'{where}: the pair kernels took another route')


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
            if name == 'lean_composite':
                # Microseconds of device work: the events above read the
                # host's issue time of each call.  Device times at the
                # chunk's rays and at a training level's.
                for rays, key in ((CHUNK, 'device_ms'),
                                  (TRAIN_RAYS, 'device_ms_train')):
                    rs, dl, md = ref_rs[:rays * N], delta[:rays], mids[:rays]
                    dev_ms = sum(v for k, v in kernel_device_ms(
                        lambda: km.lean_composite(rs, dl, md, True)).items()
                        if 'lean_composite' in k)
                    b_ms, _ = bound(name, hp, rays, N, tag)
                    results[(name, tag)][key] = dev_ms
                    log(f'[kernel] {name} {tag} at {rays} rays: device time '
                        f'(torch.profiler) {dev_ms * 1e3:.2f} us, bound '
                        f'{b_ms * 1e3:.2f} us ({100 * b_ms / dev_ms:.1f} %)')
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
    seeded head cotangents [M, 3] / [M, nd] (nd: hp's density heads); and
    the same samples' moments
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
         for c in (3, hp['nerf.mlp.num_density_channels'])]
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

        # Hybrid: on its plain forward's stream and raw heads, twice, on
        # the kernels of lean_param_grads; its time beside theirs and
        # beside torch.mm on the same weight-gradient products.
        res = km.lean_hybrid_fwd(x, view, flat, *args, dt, ACT)[2]
        km.reset_launches()
        got = hybrid(dt, res)
        again = hybrid(dt, res)
        want = hybrid(torch.float32, res, kernel=False)
        torch.cuda.synchronize()
        check_chain_routes(hp, dt, f'phase 5 hybrid {tag}',
                           lean_param_grads_hybrid=2)
        check_wgrad_routes(hp, dt, f'phase 5 hybrid {tag}',
                           lean_param_grads_hybrid=2)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        finite = all(bool(torch.isfinite(t).all()) for t in got)
        h_err, h_leaf = leaf_rel_err(got, want, leaf_names(hp))
        h_abs = max(float((a - b).abs().max()) for a, b in zip(got, want))
        del got, again, want
        report('lean_param_grads_hybrid', tag,
               finite and same and h_err <= g_bar,
               f'max leaf rel err vs the f32 plain backward {h_err:.3e} '
               f'({h_leaf}, <= {g_bar}); two runs bit-equal {same}; '
               f'max|d| {h_abs:.3e}', h_abs,
               cuda_ms(lambda: hybrid(dt, res)),
               cuda_ms(lambda: hybrid(dt, res, kernel=False)))
        h_ms = results[('lean_param_grads_hybrid', tag)]['ms']
        a_ms = results[('lean_param_grads', tag)]['ms']
        mm_ms = mm_yardstick(flat, args, res[0], dt)
        results[('lean_param_grads_hybrid', tag)]['mm_ms'] = mm_ms
        log(f'[kernel] #4c lean_param_grads_hybrid {tag}: {h_ms:.3f} ms; '
            f'#4a lean_param_grads {a_ms:.3f} ms ({h_ms / a_ms:.3f} x); '
            f'torch.mm on the same weight-gradient products {mm_ms:.3f} ms')
        del res
        compare_moments_forms(results, report, flat, args, dt, tag,
                              x, view, g_rgb, g_dens, moments, enc, hp)
    compare_render_bwd_and_encode(results, report, flat, args, x, view,
                                  moments, delta, mids, enc, hp)
    return results


def mm_yardstick(flat, args, S, dt):
    """CUDA-event ms of torch.mm on the weight-gradient products of one
    backward of the stream S in dt: each problem's activation rows of S
    against seeded cotangent rows, the library's way to the same sums,
    never called by the port."""
    N, depth, dcond, skip = args
    F, W = flat[0].shape
    Wv = flat[2 * (depth + 2)].shape[1]
    _, hs, bott, ys, _ = km.saved_rows(F, W, Wv, depth, dcond)
    first = [0] + hs + [bott] + ys
    shapes = [tuple(t.shape) for t in flat[0::2]]
    probs = km.wgrad_problems(shapes, depth, dcond, skip)[0]
    Cg = sum(n for _, n in shapes)
    gen = torch.Generator(device=S.device).manual_seed(2)
    G = torch.randn((Cg, S.shape[1]), generator=gen, device=S.device).to(dt)
    blocks = [(S[first[a]:first[a] + K], G[g:g + n])
              for a, K, g, n, _, _ in probs]

    def mm():
        for a, g in blocks:
            torch.mm(a, g.t())
    return cuda_ms(mm)


def wgrad_yardstick(hp, flat, args, saved, call):
    """Phase 5, f32: the weight gradients of one lean_param_grads call on
    their own -> {ms, bound_ms, bound_by, share, library_ms}:
    wgrad_tf32_kernel's device time in a torch.profiler window of `call`;
    its bound, the products' FLOP over the M points at the 3xTF32 rate
    against the activation and cotangent rows read once and the range sums
    written once; and torch.mm on the same products (each problem's
    activation rows of `saved` against seeded cotangent rows, CUDA events),
    the library's way to these sums, never called by the port."""
    N, depth, dcond, skip = args
    shapes = [tuple(t.shape) for t in flat[0::2]]
    probs = km.wgrad_problems(shapes, depth, dcond, skip)[0]
    Cg = sum(n for _, n in shapes)
    Mp, mc = lego_wgrad_range(hp)
    M = TRAIN_RAYS * N
    library_ms = mm_yardstick(flat, args, saved[0], torch.float32)
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
    forward on them at the phase-3 bars, in f32 against the same kernel on
    the encode rows of the plain decode of the same moments (<= FORM_BAR,
    max |d| / max |ref|), and in both dtypes bit for bit against the same
    kernels on ipe_moments' rows of those moments (one decode: outputs,
    saved stream, raw heads); lean_param_grads_recompute on the
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
    k_rows = km.ipe_moments(moments, *enc)
    one = all(torch.equal(a, b) for a, b in zip(got, fwd_parts(
        km.lean_save_fwd(k_rows, view, flat, *args, dt, ACT), M))) and all(
        torch.equal(a, b) for a, b in zip(
            lf, km.lean_fwd(k_rows, view, flat, *args, dt, ACT)))
    del k_rows
    text += f"; bit-equal to the rows form on ipe_moments' rows {one}"
    report('lean_save_fwd[moments]', tag, finite and f_ok and one, text,
           f_err,
           cuda_ms(lambda: km.lean_save_fwd(moments, view, flat, *args, dt,
                                            ACT, **kw)),
           cuda_ms(lambda: km.lean_mlp_save_plain(moments, view, flat, *args,
                                                  dt, ACT, **kw)),
           form='moments')
    l_err, l_bar, l_ok = fwd_err(lf, ref[:2], dt)
    report('lean_fwd[moments]', tag, same and l_ok and one,
           f'max|d| {l_err:.3e} ({l_bar}); bit-equal to lean_save_fwd '
           f"{same}, to the rows form on ipe_moments' rows {one}", l_err,
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
                                  moments, delta, mids, enc, hp):
    """Phase 5, f32 (both kernels are f32 in either compute dtype):
    lean_composite_bwd at a training level (3072 rays x 128, the f32 plain
    forward's activated heads, seeded per-ray cotangents, both
    backgrounds) against lean_composite_bwd_plain, max |d| / max |ref| <=
    FORM_BAR; ipe_moments on the level's moments and on a render chunk's
    (chunk_inputs: 1,048,576 points) against ipe_moments_plain, max |d| <=
    FORM_BAR, with its device time at both (torch.profiler)."""
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
    # Microseconds of device work, which the events above do not see.
    dev_ms = sum(v for k, v in kernel_device_ms(
        lambda: km.lean_composite_bwd(*b_args, True)).items()
        if 'lean_composite_bwd' in k)
    results[('lean_composite_bwd', 'f32')]['device_ms'] = dev_ms
    log(f'[kernel] lean_composite_bwd f32: device time (torch.profiler) '
        f'{dev_ms * 1e3:.2f} us, bound '
        f'{results[("lean_composite_bwd", "f32")]["bound_ms"] * 1e3:.2f} us')
    chunk = chunk_inputs(hp, x.device)[0]
    errs, ok = {}, True
    for label, mo in (('level', moments), ('render chunk', chunk)):
        got = km.ipe_moments(mo, *enc)
        want = km.ipe_moments_plain(mo, *enc)
        torch.cuda.synchronize()
        errs[label] = float((got - want).abs().max())
        ok = ok and bool(torch.isfinite(got).all()) and \
            errs[label] <= FORM_BAR
        del got, want
    dev_ms = {label: sum(v for k, v in kernel_device_ms(
        lambda: km.ipe_moments(mo, *enc)).items()
        if 'ipe_moments_kernel' in k)
        for label, mo in (('level', moments), ('render chunk', chunk))}
    report('ipe_moments', 'f32', ok,
           f'max|d| {errs["level"]:.3e} at the level ({moments.shape[1]:,} '
           f'points), {errs["render chunk"]:.3e} at a render chunk '
           f'({chunk.shape[1]:,}) (<= {FORM_BAR}); device time (torch.'
           f'profiler) {dev_ms["level"]:.4f} / {dev_ms["render chunk"]:.4f} '
           f'ms', max(errs.values()),
           cuda_ms(lambda: km.ipe_moments(moments, *enc)),
           cuda_ms(lambda: km.ipe_moments_plain(moments, *enc)))
    results[('ipe_moments', 'f32')]['device_ms'] = dev_ms['level']
    results[('ipe_moments', 'f32')]['device_ms_chunk'] = \
        dev_ms['render chunk']


def compare_ipe_kernels(hp, dev):
    """Phase 5, the standalone IPE (f32 in either compute dtype): ipe_fwd
    and ipe_bwd against their plain versions on the Gaussians of a training
    level (the stratified samples of TRAIN_RAYS seeded rays, a seeded
    cotangent), with the covariances and with them zeroed (as
    disable_integration hands them over), on a ragged number of them, with
    the means pushed out to |mean| + 3.25 (every degree-15 argument past
    105,615, where CUDA's exact sincosf turns slow) and at degrees 16..32
    (covariances zeroed, arguments up to 2^34); two runs bit-equal.
    dmeans reach ~1e5 and dcovs ~1e9 (~1e19 at degrees 16..32), so they
    are held by ||a - b|| / ||b||.  Beside the CUDA events (which also
    count the host's issue time of a call) each kernel's device time from
    a torch.profiler window, at the level."""
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
    zero = torch.zeros_like(covs)
    high = (deg[0] + 16, deg[1] + 16)
    cases = (('covs', means, covs, g, deg), ('covs = 0', means, zero, g, deg),
             ('ragged', means[:ragged], covs[:ragged], g[:ragged], deg),
             ('far', torch.sign(means) * (means.abs() + 3.25), covs, g, deg),
             (f'degrees {high[0]}..{high[1]}, covs = 0', means, zero, g,
              high))
    for label, m, c, gg, dd in cases:
        out, again = ki.ipe_fwd(m, c, *dd), ki.ipe_fwd(m, c, *dd)
        dm, dc = ki.ipe_bwd(m, c, gg, *dd)
        dm2, dc2 = ki.ipe_bwd(m, c, gg, *dd)
        want = ki.ipe_fwd_plain(m, c, *dd)
        rm, rc = ki.ipe_bwd_plain(m, c, gg, *dd)
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
    fwd = lambda: ki.ipe_fwd(means, covs, *deg)  # noqa: E731
    bwd = lambda: ki.ipe_bwd(means, covs, g, *deg)  # noqa: E731
    dev = {name: sum(v for k, v in kernel_device_ms(fn).items()
                     if f'{name}_kernel' in k)
           for name, fn in (('ipe_fwd', fwd), ('ipe_bwd', bwd))}
    report('ipe_fwd', 'f32', same and worst['fwd'] <= FORM_BAR,
           f'max|d| {worst["fwd"]:.3e} over the five cases (<= {FORM_BAR}); '
           f'device time {dev["ipe_fwd"]:.4f} ms', worst['fwd'],
           cuda_ms(fwd), cuda_ms(lambda: ki.ipe_fwd_plain(means, covs, *deg)))
    report('ipe_bwd', 'f32', same and worst['bwd'] <= FORM_BAR,
           f'||a - b|| / ||b|| {worst["bwd"]:.3e} over dmeans, dcovs and the '
           f'five cases (<= {FORM_BAR}); max|d| {worst["bwd_abs"]:.3e}; '
           f'device time {dev["ipe_bwd"]:.4f} ms', worst['bwd_abs'],
           cuda_ms(bwd),
           cuda_ms(lambda: ki.ipe_bwd_plain(means, covs, g, *deg)))
    for name, ms in dev.items():
        results[(name, 'f32')]['device_ms'] = ms
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
        km.reset_launches()
        out = km.mlp_save_fwd(x, view, flat, *args, dt)
        lf = km.mlp_fwd(x, view, flat, *args, dt)
        torch.cuda.synchronize()
        check_classic_routes(hp, dt, f'phase 5 classic forwards{label} {tag}',
                             mlp_save_fwd=1, mlp_fwd=1)
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
        check_classic_routes(hp, dt, f'phase 5 mlp_bwd_saved{label} {tag}',
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
        check_classic_routes(hp, dt, f'phase 5 mlp_bwd_recompute{label} '
                             f'{tag}', mlp_bwd_recompute=2)
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


def pair_mm_yardstick(args, g, dt, name):
    """CUDA-event ms of torch.mm on the products of one pair call in dt (a
    sum of several calls, f32 with allow_tf32 False; never called by the
    port): forward x Wcol and h Wrow; backward x Wcol, g Wrow^T, dh Wcol^T,
    x^T dh and h^T g, on operands cast to dt before the clock starts."""
    x, w_col, b_col, w_row = args
    x, wc, wr = x.to(dt), w_col.to(dt), w_row.to(dt)
    h = torch.relu(x.float() @ wc.float() + b_col).to(dt)
    if name == 'tp_pair_fwd':
        def mm():
            torch.mm(x, wc)
            torch.mm(h, wr)
    else:
        gd = g.to(dt)
        dh = (gd.float() @ wr.float().t()).to(dt)

        def mm():
            torch.mm(x, wc)
            torch.mm(gd, wr.t())
            torch.mm(dh, wc.t())
            torch.mm(x.t(), dh)
            torch.mm(h.t(), gd)
    return cuda_ms(mm)


def compare_pair_kernels(hp, dev):
    """Phase 5, the Megatron pair kernels at the three pair shapes of a lego
    level at net_width 1024 on a model axis of 2 (the first pair: f32 encode
    rows, f_in 96; a later pair; the skip pair, whose kernel sees the same
    shapes: its x-rows term is added outside), 393,216 rows and a ragged
    count, f32 and bf16, all on tp_pair_wg_kernel (bf16 and 3xTF32); and
    the mma.sync kernels at a local width the wgmma rule refuses (272 ->
    528, 4,097 rows).  Each call's kernel is asserted from the library's
    own counts (check_pair_routes).  Forward against the f32 `_pair_plain`
    at the phase-3 bars; dx, dWcol, dbcol and dWrow at the largest ||a - b||
    / ||b|| against the f32 `_pair_bwd_plain` on x and the panels as the
    kernel rounds them, with a cotangent that is zero in the rows whose
    ReLU mask is in doubt (settled_cotangent), <= 1e-4 f32, <= 3e-2 bf16;
    two backward runs bit-equal.  The numbers of the later pair at the
    level's rows are the kernels' record; the first pair's and the mma.sync
    forms' go beside them ('[first pair]', '[mma.sync]'), each with
    torch.mm on the same products (pair_mm_yardstick) as library_ms."""
    W, _, n_model = TP_MESHES[0]
    Wl = W // n_model
    F = 6 * (hp['nerf.max_deg_point'] - hp['nerf.min_deg_point'])
    M = TRAIN_RAYS * hp['nerf.num_samples']
    names = ['dx', 'dWcol', 'dbcol', 'dWrow']
    cases = [('first pair', M, F, Wl, W, 11), ('pair', M, W, Wl, W, 12),
             ('skip pair', M, W, Wl, W, 13),
             ('pair, ragged', TP_RAGGED_ROWS, W, Wl, W, 14),
             ('first pair, ragged', TP_RAGGED_ROWS, F, Wl, W, 15),
             ('mma.sync pair', TP_MMA_SHAPE[0], *TP_MMA_SHAPE[1:], 16)]
    results = {}
    report = reporter(results, hp)
    for label, rows, f_in, wl, wout, seed in cases:
        x32, *panels, g = pair_inputs(rows, f_in, wl, wout, dev, seed)
        mma = label.startswith('mma.sync')
        for dt in (torch.float32, torch.bfloat16):
            tag = 'f32' if dt == torch.float32 else 'bf16'
            g_bar = F32_BAR if dt == torch.float32 else BF16_BAR
            args = [torch.relu(x32).to(dt) if f_in == wout else x32] + panels
            g, kept = settled_cotangent(args, g, dt)
            km.reset_launches()
            out = kt._pair_call(*args, dt)
            got = kt._pair_bwd_call(*args, g, dt)
            again = kt._pair_bwd_call(*args, g, dt)
            torch.cuda.synchronize()
            check_wgrad_routes(hp, dt, f'phase 5 tp_pair_bwd, {label} {tag}',
                               tp_pair_bwd=2)
            check_pair_routes(dt, f'phase 5 {label} {tag}', (f_in, wl, wout),
                              not mma, tp_pair_fwd=1, tp_pair_bwd=2)
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
                f' x {f_in} -> {wl} -> {wout}, {tag}: forward max|d| '
                f'{f_err:.3e} ({f_bar}); backward max rel err {g_err:.3e} '
                f'({g_leaf}, <= {g_bar}; {100 * kept:.2f} % of the rows carry '
                f'a cotangent), two runs bit-equal {same}')
            if not (finite and same and f_ok and g_err <= g_bar):
                raise AssertionError(f'the pair kernels disagree with their '
                                     f'plain versions: {label} {tag}')
            if (rows != M and not mma) or label == 'skip pair':
                continue
            suffix = ('[mma.sync]' if mma else
                      '' if f_in == W else '[first pair]')
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
                       work=pair_work(name, rows, f_in, wl, wout, tag, x_f32))
                lib = pair_mm_yardstick(args, g, dt, name)
                results[(name + suffix, tag)]['library_ms'] = lib
                log(f'[kernel] {name}{suffix} {tag}: torch.mm on its '
                    f'products {lib:.3f} ms (a sum of '
                    f'{2 if name == "tp_pair_fwd" else 5} calls)')
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
            check_pair_routes(dt, f'phase 5b net_width {W} {tag}',
                              (W, W // n_model, W), True,
                              tp_pair_fwd=want_launches,
                              tp_pair_bwd=want_launches)
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
    check_chain_routes, check_wgrad_routes, and for fused_mlp's kernels
    check_classic_routes), and the loss must stay
    finite; -> the run's launch counts."""
    fn = system.make_train_many()
    state = system.init_state(params=params)
    km.reset_launches()
    state, aux, sec, _ = train_run(fn, state, stack, pix)
    run_counts = dict(km.launches)
    hp = system.hparams
    dt = getattr(torch, str(hp.get('train.compute_dtype', 'float32')))
    fwd = {n: run_counts[n] for n in km.routes
           if run_counts[n] and n not in CLASSIC_FWD}
    chain = {n: run_counts[n] for n in km.chain_routes
             if run_counts[n] and n not in CLASSIC_CHAIN}
    wgrad = {n: run_counts[n] for n in km.wgrad_tf32_routes
             if run_counts[n]}
    classic = {n: run_counts[n] for n in CLASSIC_FWD + ('mlp_bwd_saved',)
               if run_counts[n]}
    if classic:
        check_classic_routes(hp, dt, f'{label} K={TRAIN_K}', **classic)
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


def classic_slice(hp0, params, dev, what):
    """Phase 6, a model of CLASSIC_SHAPES (`hp0` its hparams, `params` its
    seeded weights, `what` its name in the log) on pallas_save and pallas
    with stop_resample_grad False, bf16 and f32: the one-step gradient gate
    against the plain path, then K steps in which the backend's forward and
    backward launch 2 levels x K times on the routes check_classic_routes
    asserts; -> {dtype: {kernel name: its launches in that dtype's K-step
    run of its backend}}."""
    rays, pixels = train_batch(TRAIN_RAYS, dev)
    stack = Rays(*(f.expand(TRAIN_K, *f.shape).contiguous() for f in rays))
    pix = pixels.expand(TRAIN_K, *pixels.shape).contiguous()
    launches = {'bfloat16': {}, 'float32': {}}
    for dtype in ('bfloat16', 'float32'):
        for backend, names in (('pallas_save', ('mlp_save_fwd',
                                                'mlp_bwd_saved')),
                               ('pallas', ('mlp_fwd', 'mlp_bwd_recompute'))):
            hb = dict(hp0, **{'train.compute_dtype': dtype,
                              'nerf.mlp_backend': backend}, **_RESAMPLE)
            label = f'{dtype} {backend}+resample, {what}'
            system = gradient_gate(hb, params, rays, pixels, dev, label)
            counts = run_k_steps(system, params, stack, pix, names,
                                 hp0['nerf.num_levels'], label)
            launches[dtype].update({n: counts[n] for n in names})
    return launches


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


def gather_times(fields, sample_indices, rows):
    """Host ms of the native gather and of numpy indexing of `rows` rows of
    `fields`, in turns, each on the same fresh draw: -> (median library
    ms, median numpy ms) of GATHER_REPS draws; raises if they differ."""
    rng = np.random.default_rng(0)
    lib_ms, np_ms = [], []
    for _ in range(GATHER_REPS):
        idx = sample_indices(rng, rows)
        t0 = time.perf_counter()
        got = native_gather.gather_multi(fields, idx)
        t1 = time.perf_counter()
        want = [f[idx] for f in fields]
        t2 = time.perf_counter()
        lib_ms.append(1e3 * (t1 - t0))
        np_ms.append(1e3 * (t2 - t1))
        if not all(np.array_equal(g, w) for g, w in zip(got, want)):
            raise AssertionError('the native gather differs from numpy')
    return float(np.median(lib_ms)), float(np.median(np_ms))


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
        # The batches came through the native gather (native/gather.py),
        # every field in its one pass.
        ds = system.train_dataset
        fields = [*ds.rays, ds.images]
        lib = native_gather.loaded()
        if lib is None or not all(map(native_gather.native_ok, fields)):
            raise AssertionError('the run gathered its batches without the '
                                 'native library')
        lib_ms, np_ms = gather_times(fields, ds.sample_indices,
                                     RUN_K * TRAIN_RAYS)
        log(f'[run] batches gathered by {lib.name} (built with '
            f'{native_gather.compiler()} in the batcher\'s set-up); batcher '
            f'wait {100 * stats["data_wait_share"]:.2f} % of the loop (PR '
            f'22: 0.21-0.24 %); a draw of {RUN_K} x {TRAIN_RAYS} rows of the '
            f'{len(fields)} fields ({ds.num_rays:,} rays), median of '
            f'{GATHER_REPS}: library {lib_ms:.4f} ms, numpy indexing '
            f'{np_ms:.4f} ms')
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


def real360_hparams(**extra):
    """configs/real360.yaml on the default schema, on pallas_lean_save."""
    hp = config.default()
    config.merge_from_file(hp, REAL360_CONFIG)
    hp['nerf.mlp_backend'] = 'pallas_lean_save'
    hp.update(extra)
    return hp


def real360_batch(B, dev, seed=0):
    """Rays of an inward-facing 360 capture: origins on the upper half of
    the radius-4 sphere, directions of length 1 to 1.1 (RealData360's are
    K_inv's pixel rays, z = 1 in the camera) toward points of the cube
    [-1, 1]^3, radius 1.6e-3 (a pixel of a 256 px view), near 2.5 and far
    5.5 (make_llff_sphere_capture's bounds); uniform pixel targets."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(B, 3))
    o[:, 2] = np.abs(o[:, 2])
    o = 4.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = rng.uniform(-1.0, 1.0, size=(B, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    viewdirs = d.copy()
    d *= rng.uniform(1.0, 1.1, size=(B, 1))
    ones = np.ones((B, 1))
    fields = (o, d, viewdirs, ones * 1.6e-3, ones, ones * 2.5, ones * 5.5)
    pixels = rng.uniform(size=(B, 3))
    return (Rays(*(torch.tensor(f, dtype=torch.float32, device=dev)
                   for f in fields)),
            torch.tensor(pixels, dtype=torch.float32, device=dev))


def real360_level_inputs(hp, dev, seed=3):
    """One training level of the real360 path: x rows = the icosahedral
    IPE of the inverse-depth samples of TRAIN_RAYS seeded 360 rays [M, 42],
    view [R, 27], seeded head cotangents [M, 3] / [M, 1]."""
    rays, _ = real360_batch(TRAIN_RAYS, dev, seed)
    _, means_covs = sample_along_rays_360(
        rays.origins, rays.directions, rays.radii, hp['nerf.num_samples'],
        rays.near, rays.far, False, 'cone')
    x = integrated_pos_enc_360(means_covs)
    x = x.reshape(-1, x.shape[-1]).contiguous()
    view = pos_enc(rays.viewdirs, 0, hp['nerf.deg_view'])
    rng = np.random.default_rng(seed + 1)
    g = [torch.tensor(rng.normal(size=(x.shape[0], c)).astype(np.float32),
                      device=dev) for c in (3, 1)]
    return x, view, g[0], g[1]


def compare_real360_kernels(params, hp, dev):
    """Phase 8a: lean_save_fwd (#3) and lean_param_grads (#4a) at the
    real360 level (3072 rays x 128 samples, F = 42) against their plain
    versions, f32 and bf16, at the phase-3 / phase-5 bars, on the routes
    the rules give (the wgmma kernels of each dtype); -> results keyed
    (name + REAL360_TAG, tag)."""
    args = (hp['nerf.num_samples'], hp['nerf.mlp.net_depth'],
            hp['nerf.mlp.net_depth_condition'], hp['nerf.mlp.skip_index'])
    flat = flat_params(params, hp)
    x, view, g_rgb, g_dens = real360_level_inputs(hp, dev)
    M, F = x.shape
    if F != xyz_features(hp) or flat[0].shape[0] != F:
        raise AssertionError(f'the real360 encode has {F} features')
    results = {}
    report = reporter(results, hp)
    ref = km.lean_mlp_save_plain(x, view, flat, *args, torch.float32, ACT)
    ref_parts = fwd_parts(ref, M)
    for dt in (torch.float32, torch.bfloat16):
        tag = 'f32' if dt == torch.float32 else 'bf16'
        g_bar = F32_BAR if dt == torch.float32 else BF16_BAR
        on = sm90_route(hp, dt), tf32_route(hp, dt), chain_route(hp, dt)
        log(f'[real360] F = {F} {tag}: forward rules (fwd_sm90_route, '
            f'fwd_tf32_route) {on[:2]}, chain rules (chain_sm90_route, '
            f'chain_tf32_route) {on[2]}')
        km.reset_launches()
        out = km.lean_save_fwd(x, view, flat, *args, dt, ACT)
        torch.cuda.synchronize()
        check_routes(hp, dt, f'phase 8a lean_save_fwd real360 {tag}',
                     lean_save_fwd=1)
        parts = fwd_parts(out, M)
        finite = all(bool(torch.isfinite(t).all()) for t in parts)
        f_err, f_bar, f_ok = fwd_err(parts, ref_parts, dt)
        report('lean_save_fwd' + REAL360_TAG, tag, finite and f_ok,
               f'max|d| {f_err:.3e} ({f_bar}), F = {F}', f_err,
               cuda_ms(lambda: km.lean_save_fwd(x, view, flat, *args, dt,
                                                ACT)),
               cuda_ms(lambda: km.lean_mlp_save_plain(x, view, flat, *args,
                                                      dt, ACT)))
        del out
        saved = ref[2] if dt == torch.float32 else \
            km.lean_mlp_save_plain(x, view, flat, *args, dt, ACT)[2]
        km.reset_launches()
        grads = km.lean_param_grads(view, g_rgb, g_dens, saved, flat, *args,
                                    dt, ACT)
        ref_grads = km.lean_param_grads_plain(view, g_rgb, g_dens, saved,
                                              flat, *args, torch.float32,
                                              ACT)
        torch.cuda.synchronize()
        check_chain_routes(hp, dt, f'phase 8a lean_param_grads real360 {tag}',
                           lean_param_grads=1)
        check_wgrad_routes(hp, dt, f'phase 8a lean_param_grads real360 {tag}',
                           lean_param_grads=1)
        shapes = all(a.shape == b.shape for a, b in zip(grads, flat))
        finite = all(bool(torch.isfinite(t).all()) for t in grads)
        g_abs = max(float((a - b).abs().max())
                    for a, b in zip(grads, ref_grads))
        g_err, g_leaf = leaf_rel_err(grads, ref_grads, leaf_names(hp))
        report('lean_param_grads' + REAL360_TAG, tag,
               finite and shapes and g_err <= g_bar,
               f'max leaf rel err vs the f32 plain backward {g_err:.3e} '
               f'({g_leaf}, <= {g_bar}); trunk_0 {tuple(grads[0].shape)}; '
               f'max|d| {g_abs:.3e}', g_abs,
               cuda_ms(lambda: km.lean_param_grads(
                   view, g_rgb, g_dens, saved, flat, *args, dt, ACT)),
               cuda_ms(lambda: km.lean_param_grads_plain(
                   view, g_rgb, g_dens, saved, flat, *args, dt, ACT)))
        del grads, ref_grads, saved
    return results


def real360_kernel_names(name, hp, dt):
    """The device kernels that check_routes / check_chain_routes /
    check_wgrad_routes let wrapper `name` (lean_save_fwd or
    lean_param_grads) of hp's MLP take in dt."""
    if name == 'lean_save_fwd':
        return {'kernel': 'lean_fwd_sm90_kernel' if sm90_route(hp, dt)
                else 'lean_fwd_tf32_kernel' if tf32_route(hp, dt)
                else 'lean_fwd_kernel (mma.sync)'}
    on = chain_route(hp, dt)
    f32 = dt == torch.float32
    return {'chain': 'lean_chain_sm90_kernel' if on[0]
            else 'lean_chain_tf32_kernel' if on[1]
            else 'lean_grad_chain_kernel (mma.sync)',
            'wgrad': 'wgrad_sm90_kernel' if not f32
            else 'wgrad_tf32_kernel'}


def real360_gates(hp0, params, dev):
    """Phase 8b: one real360 training step's gradients on
    pallas_lean_save against the plain path on the same rays and
    generator seed (gradient_gate), bf16 and f32, then again with
    nerf.fuse_render (the render-fused level, #1 / #2, compositing over
    1/t_inv): the step's launches exactly, on the routes of its dtype."""
    rays, pixels = real360_batch(TRAIN_RAYS, dev)
    levels = hp0['nerf.num_levels']
    for fused in ({}, {'nerf.fuse_render': True}):
        for dtype in ('bfloat16', 'float32'):
            hp = dict(hp0, **{'train.compute_dtype': dtype}, **fused)
            label = (f'phase 8b real360 {dtype} pallas_lean_save'
                     f'{" + fuse_render" if fused else ""}')
            km.reset_launches()
            system = gradient_gate(hp, params, rays, pixels, dev, label)
            counts = dict(km.launches)
            model = system.model
            if not model.unbounded or model._fused_render != bool(fused):
                raise AssertionError(f'{label}: the model is not the '
                                     'unbounded one asked for')
            names = _SAVE + ('lean_view_proj',) + (_COMPOSITE if fused
                                                   else ())
            want = {n: levels for n in names}
            log(f'[real360] {label}: launches '
                f'{ {k: v for k, v in counts.items() if v} } (want {want})')
            if any(counts[k] != want.get(k, 0) for k in counts):
                raise AssertionError(f'{label}: the step launched {counts}')
            dt = getattr(torch, dtype)
            check_routes(hp, dt, label, lean_save_fwd=levels)
            check_chain_routes(hp, dt, label, lean_param_grads=levels)
            check_wgrad_routes(hp, dt, label, lean_param_grads=levels)
            del system


def real360_run(root):
    """Phase 8c: make_llff_sphere_capture writes a 24-view 256 px capture
    under `root`; cli.train on configs/real360.yaml (full width, bf16,
    pallas_lean_save, data.factor 1) for REAL360_STEPS steps in dispatches
    of REAL360_K with one validation, then cli.eval (--white_bkgd False,
    the plain path); -> the training run's launch counts."""
    t0 = time.perf_counter()
    capture = make_llff_sphere_capture(os.path.join(root, 'capture'),
                                       **REAL360_CAPTURE)
    log(f'[real360] make_llff_sphere_capture {REAL360_CAPTURE}: '
        f'{time.perf_counter() - t0:.1f} s')
    out = os.path.join(root, 'out')
    km.reset_launches()
    system, state = train_cli.main([
        '--data_path', capture, '--out_dir', out, '--dataset_name',
        'real360', '--config', REAL360_CONFIG, '--max_steps',
        str(REAL360_STEPS), 'exp_name', 'real360', 'data.factor', '1',
        'train.compute_dtype', 'bfloat16', 'nerf.mlp_backend',
        'pallas_lean_save', 'train.steps_per_call', str(REAL360_K),
        'val.check_interval', str(REAL360_STEPS), 'val.sample_num', '1',
        'optimizer.lr_delay_steps', '0'])
    counts = dict(km.launches)
    hp, stats = system.hparams, system.fit_stats
    log(f'[real360] cli.train real360.yaml, {system.train_dataset.num_rays:,}'
        f' training rays, {REAL360_STEPS} steps of {system.batch_size} rays, '
        f'bf16 pallas_lean_save: loss {stats["loss_first"]:.5f} at step '
        f'{REAL360_K} -> {stats["loss_last"]:.5f} at step {REAL360_STEPS}; '
        f'{stats["rays_per_sec"]:,.0f} rays/s over the training time; the '
        f'loop waited on the batcher for '
        f'{100 * stats["data_wait_share"]:.2f} % of its '
        f'{stats["loop_seconds"]:.2f} s; launches '
        f'{ {k: v for k, v in counts.items() if v} }')
    if not system.model.unbounded or system.eval_model.mlp_backend != 'xla':
        raise AssertionError('the real360 run is not unbounded, or renders '
                             'through a kernel backend')
    if state['step'] != REAL360_STEPS or not (
            np.isfinite(stats['loss_last'])
            and stats['loss_last'] < stats['loss_first']):
        raise AssertionError(f'the real360 loss did not fall: {stats}')
    steps = hp['nerf.num_levels'] * REAL360_STEPS
    want = {'lean_save_fwd': steps, 'lean_param_grads': steps,
            'lean_view_proj': steps}
    if any(counts[k] != want.get(k, 0) for k in counts):
        raise AssertionError(f'the real360 run launched {counts}, expected '
                             f'{want} and nothing else')
    check_routes(hp, torch.bfloat16, 'phase 8c run', lean_save_fwd=steps)
    check_chain_routes(hp, torch.bfloat16, 'phase 8c run',
                       lean_param_grads=steps)
    check_wgrad_routes(hp, torch.bfloat16, 'phase 8c run',
                       lean_param_grads=steps)
    ckpt_dir = os.path.join(out, 'ckpt', 'real360')
    best = os.listdir(os.path.join(ckpt_dir, 'best'))
    last = os.listdir(os.path.join(ckpt_dir, 'last'))
    log(f'[real360] checkpoints: best {best} last {last}')
    if best != [str(REAL360_STEPS)] or last != [str(REAL360_STEPS)]:
        raise AssertionError('unexpected real360 checkpoints')
    km.reset_launches()
    t0 = time.perf_counter()
    summary = eval_cli.main(['--ckpt', ckpt_dir, '--out_dir', out,
                             '--scale', '1', '--white_bkgd', 'False',
                             '--no_video', '--chunk_size', str(CHUNK)])
    values = {}
    for name in ('psnrs', 'ssims'):
        with open(os.path.join(out, 'test', 'real360', f'{name}.txt')) as f:
            values[name] = [float(v) for v in f.read().split()]
    n_test = len(range(0, REAL360_CAPTURE['n_images'], 8))
    log(f'[real360] cli.eval ({time.perf_counter() - t0:.1f} s, plain '
        f'path): {values}; summary {summary}')
    if any(km.launches.values()):
        raise AssertionError(f'eval launched {dict(km.launches)}')
    if (any(len(v) != n_test or not np.all(np.isfinite(v))
            for v in values.values())
            or not all(np.isfinite(float(v)) for v in summary.split(' | '))):
        raise AssertionError('the real360 eval wrote no finite metrics')
    return counts


def quality_run(smi):
    """Phase 8d: tools.quality_smoke for QUALITY_STEPS steps in bf16 on
    pallas_lean_save: val PSNR >= QUALITY_MIN_PSNR, lean_save_fwd and
    lean_param_grads 2 a step."""
    km.reset_launches()
    argv = ['--steps', str(QUALITY_STEPS), '--backend', 'pallas_lean_save',
            '--dtype', 'bfloat16', '--min_psnr', str(QUALITY_MIN_PSNR)]
    try:
        result = quality_smoke.main(argv)
    except SystemExit as e:
        raise AssertionError(f'quality_smoke {" ".join(argv)} exited '
                             f'{e.code}: below {QUALITY_MIN_PSNR} dB')
    counts = dict(km.launches)
    log(f'[quality] quality_smoke {" ".join(argv)}: val PSNR '
        f'{result["val_psnr"]:.4f} dB, wall {result["wall"]:.1f} s, '
        f'{result["rays_per_sec"]:,.0f} rays/s ({smi}); launches '
        f'{ {k: v for k, v in counts.items() if v} }')
    want = 2 * QUALITY_STEPS
    if counts['lean_save_fwd'] != want or counts['lean_param_grads'] != want:
        raise AssertionError(f'quality_smoke launched {counts}')
    return result


def tools_eval_launches(levels, side, n_down, n_test, chunk):
    """Launches of each render kernel in cli.eval of a pyramid's test split:
    levels x chunks of every entry (n_test views at side / 2^l, l <
    n_down)."""
    return n_test * sum(levels * -(-(side >> l) ** 2 // chunk)
                        for l in range(n_down))


def share_ckpt(src, dst, exp_name):
    """Copy the checkpoint root `src` to `dst` under the experiment name
    `exp_name` (cli.eval writes its results under the checkpoint's
    exp_name)."""
    shutil.copytree(src, dst)
    path = os.path.join(dst, 'hparams.json')
    with open(path) as f:
        hp = json.load(f)
    with open(path, 'w') as f:
        json.dump(dict(hp, exp_name=exp_name), f, indent=2)


def tools_run(root, smi):
    """Phase 8e: tools.ablation (multi_ipe, multi_pe, single_ipe),
    tools.distloss_ablation (distloss_on, distloss_off) and
    tools.acceptance (--scene hard) at the lego width of their defaults in
    bf16 on pallas_lean_save, TOOLS_STEPS steps an arm, each stage through
    the CLIs' main in this process (stages.in_process_stage).  multi_ipe,
    distloss_on and acceptance_hard are one configuration and seed: it is
    trained once, as multi_ipe, and the other two evaluate its checkpoint
    (--skip_train).  Each
    training stage launches lean_save_fwd and lean_param_grads 2 a step on
    the bf16 wgmma kernels, multi_pe with nerf.disable_integration (zero
    covariances) on both its models; each eval renders through lean_mlp
    and lean_composite (levels x chunks of every test entry) on the bf16
    wgmma forward and launches no training kernel; every report exists
    with finite per-scale PSNR / SSIM, each arm's average PSNR >= its
    floor (TOOLS_MIN_PSNR); the sign checks are printed.  Then
    export_html of the scene's cameras, and the PNG where matplotlib
    imports.  -> {stage label: launch counts}."""
    counts = {}
    chunk = eval_cli.make_parser().get_default('chunk_size')
    bf16 = torch.bfloat16

    def stage(module, argv):
        flags = {a: b for a, b in zip(argv, argv[1:]) if a.startswith('--')}
        km.reset_launches()
        t0 = time.perf_counter()
        result = stages.in_process_stage(module, argv)
        torch.cuda.synchronize()
        c = dict(km.launches)
        if module == stages.CONVERT:
            if any(c.values()):
                raise AssertionError(f'cli.convert launched {c}')
            return result
        if module == stages.TRAIN:
            system, state = result
            hp, name = system.hparams, system.hparams['exp_name']
            label = f'train {name}'
            n = hp['nerf.num_levels'] * system.fit_stats['steps']
            if system.fit_stats['steps'] != TOOLS_STEPS or \
                    state['step'] != TOOLS_STEPS:
                raise AssertionError(f'{label} ran {system.fit_stats}')
            if hp['train.compute_dtype'] != 'bfloat16' or \
                    system.model.mlp_backend != 'pallas_lean_save':
                raise AssertionError(f'{label} is not bf16 pallas_lean_save')
            if c['lean_save_fwd'] != n or c['lean_param_grads'] != n:
                raise AssertionError(f'{label} launched {c}, want {n} of '
                                     'lean_save_fwd and lean_param_grads')
            check_routes(hp, bf16, f'phase 8e {label}', lean_save_fwd=n,
                         lean_mlp=c['lean_mlp'])
            check_chain_routes(hp, bf16, f'phase 8e {label}',
                               lean_param_grads=n)
            check_wgrad_routes(hp, bf16, f'phase 8e {label}',
                               lean_param_grads=n)
            multi_pe = name == 'multi_pe'
            if (system.model.disable_integration != multi_pe
                    or system.eval_model.disable_integration != multi_pe):
                raise AssertionError(f'{label}: disable_integration is not '
                                     f'{multi_pe}')
            if not c['lean_mlp'] or not c['lean_composite']:
                raise AssertionError(f'{label}: the validation rendered no '
                                     f'frame through the kernels: {c}')
            log(f'[tools] {label} ({system.train_dataset.num_rays:,} rays, '
                f'{hp["dataset_name"]}): loss '
                f'{system.fit_stats["loss_first"]:.5f} -> '
                f'{system.fit_stats["loss_last"]:.5f}, '
                f'{system.fit_stats["rays_per_sec"]:,.0f} rays/s; batcher '
                f'wait {100 * system.fit_stats["data_wait_share"]:.2f} %')
        else:
            name = os.path.basename(flags['--ckpt'].rstrip('/'))
            label = f'eval {name}'
            hp = load_hparams(flags['--ckpt'])
            n = tools_eval_launches(hp['nerf.num_levels'], TOOLS_SIZE,
                                    int(flags['--scale']),
                                    stages.SCENE_VIEWS['n_test'], chunk)
            want = {k: n if k in RENDER_KERNELS else 0 for k in c}
            if c != want:
                raise AssertionError(f'{label} launched {c}, want {want}')
            check_routes(hp, bf16, f'phase 8e {label}', lean_mlp=n)
        counts[label] = c
        log(f'[tools] {label}: {time.perf_counter() - t0:.1f} s; launches '
            f'{ {k: v for k, v in c.items() if v} }')
        return result

    common = ['--size', str(TOOLS_SIZE), '--n_down', str(TOOLS_LEVELS),
              '--steps', str(TOOLS_STEPS)]
    out = {'ablation': os.path.join(root, 'ablation'),
           'distloss': os.path.join(root, 'distloss'),
           'acceptance': os.path.join(root, 'acceptance')}
    abl = ablation.main(['--out', out['ablation']] + common + TOOLS_OPTS,
                        stage=stage)
    # distloss_on and acceptance --scene hard train multi_ipe's
    # configuration (loss.distloss_mult 0.01, the schema's) from its seed
    # on the same scene: they take its checkpoint under their own names,
    # and every arm is evaluated as the tools evaluate it.
    src = os.path.join(out['ablation'], 'ckpt', 'multi_ipe')
    if load_hparams(src)['loss.distloss_mult'] != 0.01:
        raise AssertionError('multi_ipe is not the distloss_on arm')
    for tool, name in (('distloss', 'distloss_on'),
                       ('acceptance', 'acceptance_hard')):
        share_ckpt(src, os.path.join(out[tool], 'ckpt', name), name)
    dist = distloss_ablation.main(['--out', out['distloss'], '--skip_train',
                                   'distloss_on'] + common + TOOLS_OPTS,
                                  stage=stage)
    acc = acceptance.main(['--out', out['acceptance'], '--scene', 'hard',
                           '--skip_train'] + common + TOOLS_OPTS,
                          stage=stage)
    averages = {}
    for tool, report, rows in (
            ('ablation', 'ABLATION.md', {k: abl[k] for k in (
                'multi_ipe', 'multi_pe', 'single_ipe')}),
            ('distloss', 'DISTLOSS.md', dist),
            ('acceptance', 'ACCEPTANCE.md', {'acceptance_hard': {
                'psnr': acc['psnr_per_scale'],
                'ssim': acc['ssim_per_scale']}})):
        if not os.path.exists(os.path.join(out[tool], report)):
            raise AssertionError(f'{tool} wrote no {report}')
        for arm, r in rows.items():
            psnr, ssim = np.asarray(r['psnr']), np.asarray(r['ssim'])
            if psnr.shape != (TOOLS_LEVELS,) or not (
                    np.all(np.isfinite(psnr)) and np.all(np.isfinite(ssim))):
                raise AssertionError(f'{arm}: per-scale {psnr} {ssim}')
            averages[arm] = float(psnr.mean())
            log(f'[tools] {arm}: PSNR per scale '
                f'{[round(float(v), 3) for v in psnr]}, SSIM '
                f'{[round(float(v), 4) for v in ssim]}, average '
                f'{averages[arm]:.3f} dB (floor {TOOLS_MIN_PSNR[arm]})')
    for check in abl['checks']:
        log(f'[tools] sign check (printed, not gated at {TOOLS_STEPS} '
            f'steps): {check["desc"]}: {check["delta"]:+.3f} dB, '
            f'{"PASS" if check["pass"] else "FAIL"}')
    log(f'[tools] distloss 0.01 vs 0: average PSNR '
        f'{averages["distloss_on"]:.3f} vs {averages["distloss_off"]:.3f} '
        f'dB; acceptance (hard scene) {acc["psnr_avg"]:.3f} dB / SSIM '
        f'{acc["ssim_avg"]:.4f}; {smi}')
    low = {arm: v for arm, v in averages.items() if v < TOOLS_MIN_PSNR[arm]}
    if low:
        raise AssertionError(f'phase 8e: below the floor: {low}')

    # The camera visualizer on the scene the tools wrote.
    scene = os.path.join(out['ablation'], 'scene_src', 'hard')
    size, focal, c2ws = visualize_cameras.load_blender_cameras(scene)
    sets = [('#4caf50', [(size, focal, c) for c in c2ws]),
            ('blue', visualize_cameras.load_multicam_cameras(
                os.path.join(out['ablation'], 'multiscale', 'hard')))]
    html = visualize_cameras.export_html(
        sets, os.path.join(root, 'cameras.html'), spheric_path=True)
    try:
        png = visualize_cameras.visualize_cameras(
            sets, os.path.join(root, 'cameras.png'), spheric_path=True)
        wrote = f'export_html and the PNG ({os.path.getsize(png):,} B)'
    except ImportError as e:     # the PNG needs matplotlib
        wrote = f'export_html only ({e})'
    log(f'[tools] visualize_cameras: {wrote}; the HTML viewer '
        f'{os.path.getsize(html):,} B, {len(sets[0][1])} + '
        f'{len(sets[1][1])} cameras and the orbit')
    return counts


def dp_hparams(dtype, **extra):
    """Phase 9's model: the lego schema at full width on pallas_lean_save
    with randomized sampling."""
    return dict(config.default(), **{
        'train.compute_dtype': dtype, 'nerf.mlp_backend': 'pallas_lean_save',
        'train.randomized': True, 'optimizer.lr_delay_steps': 0}, **extra)


def step_from(system, params, rays, pixels):
    """One value_and_grad and one train_step of `system` from `params` on
    the batch with step generator (7, 0); -> (loss, gradients, parameter
    update, launch counts of the train_step, its pair routes as
    check_pair_routes reads them)."""
    _, g = system.value_and_grad(system.init_state(params=params)['params'],
                                 rays, pixels, system.step_generator(7, 0))
    state = system.init_state(params=params)
    start = [v.detach().clone() for v in state['params'].values()]
    km.reset_launches()
    state, aux = system.train_step(state, rays, pixels,
                                   system.step_generator(7, 0))
    torch.cuda.synchronize()
    tables = (km.pair_sm90_routes, km.pair_tf32_routes, km.pair_mma_routes)
    routes = {k: tuple(t[k] for t in tables)
              for k in ('tp_pair_fwd', 'tp_pair_bwd')}
    return (float(aux['loss']), [g[k] for k in state['params']],
            [v.detach() - a for v, a in zip(state['params'].values(), start)],
            dict(km.launches), routes)


def dp_step(params, dev):
    """Phase 9a: the single-process mesh of DP_SHARDS shards on the card
    against data 1, f32 then bf16, from the same parameters on the same
    batch and step generator: the loss (f32 within 1e-6 relative), the
    largest leaf ||a - b|| / ||b|| of the one-step parameter update and of
    the gradients (<= F32_GATE_BAR f32, <= BF16_BAR bf16), lean_save_fwd /
    lean_param_grads launched 2 levels x DP_SHARDS a step on the routes of
    their dtype; then ms/step of each in turns (one, mesh, mesh, one) of
    DP_K-step calls.  -> ({dtype: the mesh step's launch counts}, numbers
    for the log)."""
    rays, pixels = train_batch(TRAIN_RAYS, dev)
    stack = Rays(*(f.expand(DP_K, *f.shape).contiguous() for f in rays))
    pix = pixels.expand(DP_K, *pixels.shape).contiguous()
    shard_rays = TRAIN_RAYS // DP_SHARDS
    counts, report = {}, {}
    for dtype in ('float32', 'bfloat16'):
        dt = getattr(torch, dtype)
        hp = dp_hparams(dtype)
        systems = {'data 1': MipNeRFSystem(hp, device=dev),
                   f'data {DP_SHARDS}': MipNeRFSystem(
                       hp, mesh=create_mesh(DP_SHARDS, device=dev))}
        got = [step_from(s, params, rays, pixels) for s in systems.values()]
        names = list(params)
        (l1, g1, d1, _, _), (l2, g2, d2, c2, _) = got
        loss_rel = abs(l2 - l1) / abs(l1)
        step_err, step_leaf = leaf_rel_err(d2, d1, names)
        grad_err, grad_leaf = leaf_rel_err(g2, g1, names)
        bar = F32_GATE_BAR if dtype == 'float32' else BF16_BAR
        want = hp['nerf.num_levels'] * DP_SHARDS
        log(f'[dp] 9a {dtype} data {DP_SHARDS} vs data 1, one step: loss '
            f'{l2:.7f} vs {l1:.7f} (rel {loss_rel:.2e}); parameter update '
            f'max leaf rel err {step_err:.3e} ({step_leaf}), gradients '
            f'{grad_err:.3e} ({grad_leaf}), bar {bar}; launches '
            f'{ {k: v for k, v in c2.items() if v} }')
        if (dtype == 'float32' and loss_rel > 1e-6) or step_err > bar \
                or grad_err > bar:
            raise AssertionError(f'phase 9a {dtype}: data {DP_SHARDS} '
                                 'disagrees with data 1')
        if any(c2[k] != (want if k in DP_STEP_KERNELS else 0) for k in c2):
            raise AssertionError(f'phase 9a {dtype}: expected {want} launches '
                                 f'of each of {_SAVE}, got {c2}')
        # The routes of the mesh's step, the last one counted.
        check_routes(hp, dt, f'phase 9a {dtype}', lean_save_fwd=want)
        check_chain_routes(hp, dt, f'phase 9a {dtype}', lean_param_grads=want)
        check_wgrad_routes(hp, dt, f'phase 9a {dtype}', rays=shard_rays,
                           lean_param_grads=want)
        counts[dtype] = c2
        fns = {n: s.make_train_many() for n, s in systems.items()}
        states = {n: s.init_state(params=params) for n, s in systems.items()}
        times = {n: [] for n in systems}
        order = list(systems)
        for which in order:                                   # warm-up
            states[which] = train_run(fns[which], states[which], stack,
                                      pix)[0]
        for which in order + order[::-1]:
            states[which], aux, sec, peak = train_run(
                fns[which], states[which], stack, pix)
            times[which].append(sec * 1e3 / DP_K)
        report[dtype] = {n: min(v) for n, v in times.items()}
        log(f'[dp] 9a {dtype} ms/step over {DP_K}-step calls, in turns: '
            f'{ {n: [round(t, 3) for t in v] for n, v in times.items()} }')
        del systems, fns, states
    return counts, report


def dp_worker(rank: int, port: int, root: str) -> int:
    """One process of phase 9b (chip_smoke.py --dp-worker RANK PORT ROOT):
    a gloo group of DP_SHARDS processes on cuda:0, fit of DP_STEPS steps
    (bf16 pallas_lean_save, one validation and one checkpoint at the end)
    on the scene under root, the lean routes of its launches checked, the
    time of the gradients' all-reduce alone, and a render of val view 0;
    writes root/rank<r>.npz (the parameters, the render) and
    root/rank<r>.json (launches, fit_stats, all-reduce ms)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    maybe_initialize_distributed(
        {'parallel.multi_host': True,
         'parallel.coordinator_address': f'localhost:{port}',
         'parallel.num_processes': DP_SHARDS, 'parallel.process_id': rank},
        device='cuda', timeout_s=DP_TIMEOUT, backend='gloo')
    try:
        dev = torch.device('cuda', 0)
        hp = dp_run_hparams()
        system = MipNeRFSystem(hp, device=dev)
        mesh = system.mesh
        print(f'mesh: {mesh!r}', flush=True)
        if not mesh.distributed or mesh.shape != {'data': DP_SHARDS,
                                                  'model': 1}:
            raise AssertionError(f'rank {rank}: mesh {mesh!r}')
        km.reset_launches()
        state = system.fit(os.path.join(root, 'scene'), 'blender',
                           os.path.join(root, 'out'), max_steps=DP_STEPS,
                           log_every=DP_K)
        torch.cuda.synchronize()
        counts = dict(km.launches)
        steps = hp['nerf.num_levels'] * DP_STEPS
        check_routes(hp, torch.bfloat16, f'phase 9b rank {rank}',
                     lean_save_fwd=steps)
        check_chain_routes(hp, torch.bfloat16, f'phase 9b rank {rank}',
                           lean_param_grads=steps)
        check_wgrad_routes(hp, torch.bfloat16, f'phase 9b rank {rank}',
                           rays=TRAIN_RAYS // DP_SHARDS,
                           lean_param_grads=steps)
        # The all-reduce of a step's gradients (and its five loss sums)
        # alone, as the step makes it.
        grads = [torch.randn_like(p) for p in state['params'].values()]
        grads.append(torch.zeros(5, device=system.device))
        mesh.reduce_from_data([grads])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            mesh.reduce_from_data([grads])
        torch.cuda.synchronize()
        allreduce_ms = (time.perf_counter() - t0) * 1e3 / 10
        cam, (h, w) = system.val_dataset.camera(0)
        img = system.render_camera(state['params'], cam, h, w)['fine_rgb']
        np.savez(os.path.join(root, f'rank{rank}.npz'), img=img,
                 **{k: v.detach().cpu().numpy()
                    for k, v in state['params'].items()})
        with open(os.path.join(root, f'rank{rank}.json'), 'w') as f:
            json.dump({'launches': counts, 'fit_stats': system.fit_stats,
                       'allreduce_ms': allreduce_ms}, f)
    finally:
        torch.distributed.destroy_process_group()
    return 0


def dp_run_hparams():
    """Phase 9b's run: bf16 pallas_lean_save at lego width over DP_SHARDS
    processes, dispatches of DP_K steps, validation (one view) and a
    checkpoint at DP_STEPS only."""
    return dp_hparams('bfloat16', **{
        'num_devices': DP_SHARDS, 'exp_name': 'dp',
        'train.steps_per_call': DP_K, 'val.check_interval': DP_STEPS,
        'val.sample_num': 1})


def run_script_workers(flag: str, n: int, root: str, same: bool = True):
    """Start `python3 chip_smoke.py FLAG RANK PORT ROOT` for ranks 0..n-1
    (their output into root/rank<r>.log), wait up to DP_TIMEOUT seconds,
    kill any left; -> (the logs' texts, each rank's root/rank<r>.npz
    arrays, each rank's root/rank<r>.json).  Raises when a worker failed
    or, with `same`, a rank's arrays differ from rank 0's in a bit."""
    with socket.socket() as sock:
        sock.bind(('localhost', 0))
        port = sock.getsockname()[1]
    logs = [os.path.join(root, f'rank{r}.log') for r in range(n)]
    procs = []
    try:
        for r in range(n):
            with open(logs[r], 'w') as f:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), flag,
                     str(r), str(port), root], stdout=f,
                    stderr=subprocess.STDOUT))
        deadline = time.monotonic() + DP_TIMEOUT
        while any(p.poll() is None for p in procs) and \
                time.monotonic() < deadline and not any(
                    p.poll() not in (None, 0) for p in procs):
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    texts = []
    for path in logs:
        with open(path) as f:
            texts.append(f.read())
    if any(p.returncode != 0 for p in procs):
        raise AssertionError(f'{flag}: a worker failed (codes '
                             f'{[p.returncode for p in procs]}):\n' +
                             '\n'.join(t[-3000:] for t in texts))
    ranks, infos = [], []
    for r in range(n):
        with np.load(os.path.join(root, f'rank{r}.npz')) as z:
            ranks.append({k: z[k] for k in z.files})
        with open(os.path.join(root, f'rank{r}.json')) as f:
            infos.append(json.load(f))
    for r in range(1, n if same else 1):
        diff = [k for k in ranks[0] if not np.array_equal(ranks[0][k],
                                                          ranks[r][k])]
        if diff:
            raise AssertionError(f'{flag}: rank {r} differs from rank 0 in '
                                 f'{diff}')
    return texts, ranks, infos


def dp_run(root, dev):
    """Phase 9b: DP_SHARDS processes on the one card over gloo (NCCL takes
    no two ranks on one device), each fit() of DP_STEPS steps: their final
    parameters equal bit for bit; within BF16_BAR of a single-process
    data-DP_SHARDS fit of the same steps (largest leaf rel err of the
    update from the initial parameters); the loss falls; one checkpoint
    and one CSV row, written by rank 0 alone (rank 1 prints no log line);
    the sharded render of val view 0 within FRAME_BAR of the data-1 render
    of the same parameters.  The kernels are those phase 2 built: the
    children load the hash-named libraries from the build directory.  ->
    rank 0's launch counts."""
    t_phase = time.perf_counter()
    scene = make_sphere_scene(os.path.join(root, 'scene'), **DP_SCENE)
    texts, ranks, infos = run_script_workers('--dp-worker', DP_SHARDS, root)
    t_workers = time.perf_counter() - t_phase
    hp = dp_run_hparams()
    names = sorted(k for k in ranks[0] if k != 'img')
    init = MipNeRFSystem(hp, mesh=create_mesh(DP_SHARDS, device=dev)
                         ).init_params()
    single = MipNeRFSystem(hp, mesh=create_mesh(DP_SHARDS, device=dev))
    state = single.fit(scene, 'blender', os.path.join(root, 'single'),
                       max_steps=DP_STEPS, verbose=False)
    err, leaf = leaf_rel_err(
        [torch.from_numpy(ranks[0][k]) - init[k].cpu() for k in names],
        [state['params'][k].detach().cpu() - init[k].cpu() for k in names],
        names)
    stats = infos[0]['fit_stats']
    one = MipNeRFSystem(dict(hp, num_devices=1), device=dev)
    cam, (h, w) = make_dataset(hp, 'blender', scene, 'val').camera(0)
    want = one.render_camera({k: torch.from_numpy(ranks[0][k]) for k in names},
                             cam, h, w)['fine_rgb']
    d_rgb = float(np.abs(ranks[0]['img'] - want).max())
    out = os.path.join(root, 'out')
    with open(os.path.join(out, 'logs', 'dp', 'val_history.csv')) as f:
        rows = f.read().split()[1:]
    ckpts = {k: os.listdir(os.path.join(out, 'ckpt', 'dp', k))
             for k in ('best', 'last')}
    step_lines = [t.count(f'/{DP_STEPS} loss=') for t in texts]
    step_ms = stats['steps'] and TRAIN_RAYS / stats['rays_per_sec'] * 1e3
    share = infos[0]['allreduce_ms'] / step_ms
    log(f'[dp] 9b {DP_SHARDS} gloo processes on cuda:0, fit {DP_STEPS} '
        f'steps bf16 pallas_lean_save: {t_workers:.1f} s with start-up; '
        f'{stats["rays_per_sec"]:,.0f} rays/s over the training time '
        f'({step_ms:.2f} ms/step); the gradients\' all-reduce alone '
        f'{infos[0]["allreduce_ms"]:.3f} ms, {100 * share:.1f} % of the '
        f'step; batcher wait {100 * stats["data_wait_share"]:.2f} % (rank 0)'
        f', {100 * infos[1]["fit_stats"]["data_wait_share"]:.2f} % (rank 1);'
        f' loss {stats["loss_first"]:.5f} -> {stats["loss_last"]:.5f}; '
        f'ranks bit-equal; vs the single-process data-{DP_SHARDS} fit: max '
        f'leaf rel err of the update {err:.3e} ({leaf}, bar {BF16_BAR}); '
        f'val view 0 vs data 1 max|d rgb| {d_rgb:.3e} (bar {FRAME_BAR}); '
        f'checkpoints {ckpts}, CSV rows {rows}, log lines per rank '
        f'{step_lines}; rank 0 launches '
        f'{ {k: v for k, v in infos[0]["launches"].items() if v} }')
    if err > BF16_BAR or d_rgb > FRAME_BAR:
        raise AssertionError('phase 9b: the run disagrees with the '
                             'single-process mesh or with data 1')
    if not stats['loss_last'] < stats['loss_first']:
        raise AssertionError(f'phase 9b: the loss did not fall: {stats}')
    if ckpts != {'best': [str(DP_STEPS)], 'last': [str(DP_STEPS)]} or \
            [r.split(',')[0] for r in rows] != [str(DP_STEPS)] or \
            step_lines[0] < 1 or any(step_lines[1:]):
        raise AssertionError('phase 9b: the files or log lines are not '
                             'rank 0\'s alone')
    log(f'[dp] phase 9b: {time.perf_counter() - t_phase:.1f} s')
    return infos[0]['launches']


def pair_dims(hp, m):
    """(f_in, local width, output width) of each Megatron pair of the
    model's trunk at model m: the first pair reads the encode, a pair after
    a skip at its boundary concat([h, x]) (W + F), the others h."""
    depth, skip = hp['nerf.mlp.net_depth'], hp['nerf.mlp.skip_index']
    W, F = hp['nerf.mlp.net_width'], xyz_features(hp)
    skips = set(range(skip, depth, skip))
    return [(F if e == 0 else W + F if e - 1 in skips else W, W // m, W)
            for e in range(0, depth - 1, 2)]


def check_tp_launches(counts, routes, hp, dt, d, m, where):
    """Raise unless a step of the training MLP split over data d x model m
    launched tp_pair_fwd and tp_pair_bwd once a pair, model rank, data
    shard and level (none on 'xla') and no other kernel, each pair call on
    the tp_pair_wg_kernel of dt at every pair's widths (`pair_dims`;
    check_pair_routes' rule and table, from the step's own route
    counts)."""
    pallas = hp['nerf.mlp_backend'] != 'xla'
    dims = pair_dims(hp, m)
    n = len(dims) * m * d * hp['nerf.num_levels'] if pallas else 0
    want = {k: (n if k in ('tp_pair_fwd', 'tp_pair_bwd') else 0)
            for k in counts}
    if counts != want:
        raise AssertionError(f'{where}: launches '
                             f'{ {k: v for k, v in counts.items() if v} }, '
                             f'expected {n} of each pair kernel and no other')
    kernels = {pair_kernel(dt, *w) for w in dims}
    if len(kernels) != 1:
        raise AssertionError(f'{where}: the pairs {dims} route to '
                             f'{sorted(kernels)}')
    (i, name), = kernels
    route_want = {k: tuple(n if j == i else 0 for j in range(3))
                  for k in routes}
    log(f'[route] {where}: pair calls on (tp_pair_wg_kernel bf16, '
        f'tp_pair_wg_kernel f32, mma.sync) {routes} (want {route_want}: '
        f'{name}) {"OK" if routes == route_want else "FAIL"}')
    if i == 2 or routes != route_want:
        raise AssertionError(f'{where}: the pair kernels took another route')
    return n


def tp_step(params, dev):
    """Phase 9c: tensor parallelism through the system at lego width
    (pallas_lean_save, train.randomized True), f32 then bf16: the
    single-process meshes TP_SYSTEM_MESHES on the card against data 1 x
    model 1, one step from the same parameters on the same batch and step
    generator: the loss (f32 within 1e-5 relative) and the largest leaf
    rel err of the gradients (<= F32_GATE_BAR f32, <= BF16_BAR bf16); the
    update of data 2 x model 2 against data 1 x model 2 at the same bars
    (phase 9a's comparison: the same kernels on each point).  Against
    model 1 the update is printed, not gated: Adam's first step is ~ lr
    sign(g), so the gradients' rounding differences between two kernel
    paths flip whole steps of the gradients near zero.  The pairs
    tp_pair_fwd / tp_pair_bwd launch 4 x model x data x 2 levels a step
    on the tp_pair_wg_kernel of the dtype and nothing else does
    (lean_save_fwd / lean_param_grads 0); one 'xla' step at data 1 x model
    2 launches nothing and passes the same gate against 'xla' at model 1;
    then ms/step and peak GiB of DP_K-step calls in turns (there and
    back).  -> ({label: the step's launch counts}, ms/step)."""
    rays, pixels = train_batch(TRAIN_RAYS, dev)
    stack = Rays(*(f.expand(DP_K, *f.shape).contiguous() for f in rays))
    pix = pixels.expand(DP_K, *pixels.shape).contiguous()
    counts, report = {}, {}
    for dtype in ('float32', 'bfloat16'):
        dt = getattr(torch, dtype)
        hp = dp_hparams(dtype)
        hx = dict(hp, **{'nerf.mlp_backend': 'xla'})
        bar = F32_GATE_BAR if dtype == 'float32' else BF16_BAR
        # (label, hparams, data, model, the label of its reference)
        cases = [('model 1', hp, 1, 1, None), ('xla model 1', hx, 1, 1, None)]
        cases += [(f'data {d} x model {m}', hp, d, m, 'model 1')
                  for d, m in TP_SYSTEM_MESHES]
        cases.append(('xla data 1 x model 2', hx, 1, 2, 'xla model 1'))
        systems, got = {}, {}
        for label, h, d, m, ref in cases:
            with contextlib.redirect_stdout(io.StringIO()) as said:
                systems[label] = MipNeRFSystem(
                    h, device=dev, mesh=None if m == 1 else
                    create_mesh(d * m, m, device=dev))
            got[label] = step_from(systems[label], params, rays, pixels)
            if ref is None:
                continue
            loss, grads, update, c, routes = got[label]
            l1, g1, d1 = got[ref][:3]
            names = list(params)
            loss_rel = abs(loss - l1) / abs(l1)
            step_err, step_leaf = leaf_rel_err(update, d1, names)
            grad_err, grad_leaf = leaf_rel_err(grads, g1, names)
            where = f'phase 9c {dtype} {label}'
            n = check_tp_launches(c, routes, h, dt, d, m, where)
            # The update against data 1 of the same model axis: the same
            # kernels on each point, the shards' sums in another order.
            same = f'data 1 x model {m}'
            dp_err, dp_leaf = (leaf_rel_err(update, got[same][2], names)
                               if d > 1 else (0.0, '-'))
            log(f'[tp] 9c {dtype} {label} vs {ref}, one step: loss '
                f'{loss:.7f} vs {l1:.7f} (rel {loss_rel:.2e}); gradients max '
                f'leaf rel err {grad_err:.3e} ({grad_leaf}), bar {bar}; '
                f'update {step_err:.3e} ({step_leaf}; not gated: Adam\'s '
                f'first step is ~ lr sign(g)); update vs {same} '
                f'{dp_err:.3e} ({dp_leaf}), bar {bar}; pair launches {n} + '
                f'{n}; {said.getvalue().strip()}')
            if (dtype == 'float32' and loss_rel > 1e-5) or dp_err > bar \
                    or grad_err > bar:
                raise AssertionError(f'{where} disagrees with {ref}')
            counts[f'9c {dtype} {label} step'] = c
        order = ['model 1'] + [f'data {d} x model {m}'
                               for d, m in TP_SYSTEM_MESHES] + \
            ['xla data 1 x model 2']
        fns = {n: systems[n].make_train_many() for n in order}
        states = {n: systems[n].init_state(params=params) for n in order}
        times = {n: [] for n in order}
        peaks = {}
        for which in order:                                   # warm-up
            states[which] = train_run(fns[which], states[which], stack,
                                      pix)[0]
        for which in order + order[::-1]:
            states[which], aux, sec, peak = train_run(
                fns[which], states[which], stack, pix)
            times[which].append(sec * 1e3 / DP_K)
            peaks[which] = max(peaks.get(which, 0.0), peak)
        report[dtype] = {n: min(v) for n, v in times.items()}
        log(f'[tp] 9c {dtype} ms/step over {DP_K}-step calls, in turns: '
            f'{ {n: [round(t, 3) for t in v] for n, v in times.items()} }; '
            f'peak GiB { {n: round(v, 3) for n, v in peaks.items()} }')
        del systems, fns, states
        torch.cuda.empty_cache()
    return counts, report


def tp_wide_step(dev):
    """Phase 9d: the width bench.py takes with BENCH_NET_WIDTH=1024
    (net_width 1024, condition 128) in bf16: one pallas_lean_save step at
    data 1 x model 2 (the pairs at a local width of 512) against 'xla' at
    model 1 of the same width and seeded weights, the gradients at the
    bf16 bar (the update printed, as in phase 9c), 16 + 16 pair launches
    on tp_pair_wg_kernel<bf16>; ms/step (2-step calls, in turns) and peak
    GiB of both.  -> {label: the step's launch counts}."""
    hp = dp_hparams('bfloat16', **TP_WIDE)
    hx = dict(hp, **{'nerf.mlp_backend': 'xla'})
    W = hp['nerf.mlp.net_width']
    params = jax_params_to_torch(flax_tree(MipNeRFSystem(hp, device=dev),
                                           seed=0), device=dev)
    rays, pixels = train_batch(TRAIN_RAYS, dev)
    stack = Rays(*(f.expand(2, *f.shape).contiguous() for f in rays))
    pix = pixels.expand(2, *pixels.shape).contiguous()
    with contextlib.redirect_stdout(io.StringIO()):
        systems = {'xla model 1': MipNeRFSystem(hx, device=dev),
                   'model 2': MipNeRFSystem(
                       hp, mesh=create_mesh(2, 2, device=dev))}
    got = {n: step_from(s, params, rays, pixels) for n, s in systems.items()}
    loss, grads, update, c, routes = got['model 2']
    l1, g1, d1, c1 = got['xla model 1'][:4]
    if any(c1.values()):
        raise AssertionError(f'phase 9d: xla launched {c1}')
    names = list(params)
    step_err, step_leaf = leaf_rel_err(update, d1, names)
    grad_err, grad_leaf = leaf_rel_err(grads, g1, names)
    n = check_tp_launches(c, routes, hp, torch.bfloat16, 1, 2,
                          'phase 9d bf16 width 1024 model 2')
    order = list(systems)
    fns = {k: s.make_train_many() for k, s in systems.items()}
    states = {k: s.init_state(params=params) for k, s in systems.items()}
    times, peaks = {k: [] for k in order}, {}
    for which in order + order + order[::-1]:
        states[which], aux, sec, peak = train_run(fns[which], states[which],
                                                  stack, pix)
        times[which].append(sec * 1e3 / 2)
        peaks[which] = max(peaks.get(which, 0.0), peak)
    log(f'[tp] 9d bf16 net_width {W}: model 2 vs xla model 1, one step: '
        f'loss {loss:.6f} vs {l1:.6f}; gradients max leaf rel err '
        f'{grad_err:.3e} ({grad_leaf}), bar {BF16_BAR}; update '
        f'{step_err:.3e} ({step_leaf}; not gated); pair launches {n} + '
        f'{n}; ms/step of 2-step calls (the first a warm-up) '
        f'{ {k: [round(t, 3) for t in v] for k, v in times.items()} }; peak '
        f'GiB { {k: round(v, 3) for k, v in peaks.items()} }')
    if grad_err > BF16_BAR:
        raise AssertionError('phase 9d: model 2 disagrees with xla model 1')
    del systems, fns, states, params
    torch.cuda.empty_cache()
    return {'9d bf16 width 1024 model 2 step': c}


def tp_shapes_step(dev):
    """Phase 9f: the model shapes the Megatron pairs alone do not take
    (TP_SHAPES), bf16 at the width of TP_WIDE and f32 at lego width: one
    pallas_lean_save step at data 1 x model 2 of the single-process mesh
    against 'xla' at model 1, the same seeded parameters, batch and step
    generator: the gradients' largest leaf rel err within BF16_BAR bf16 /
    F32_GATE_BAR f32, the f32 loss within 1e-5 relative, the update
    printed (phase 9c: Adam's first step is ~ lr sign(g)); tp_pair_fwd /
    tp_pair_bwd launched once a pair, rank and level, every pair, the
    boundary pair of f_in = W + F too, on the tp_pair_wg_kernel of the
    dtype (the route counts), and nothing else; ms/step of 2-step calls
    (there and back) and peak GiB of both systems.  -> {label: the step's
    launch counts}."""
    t_phase = time.perf_counter()
    rays, pixels = train_batch(TRAIN_RAYS, dev)
    stack = Rays(*(f.expand(2, *f.shape).contiguous() for f in rays))
    pix = pixels.expand(2, *pixels.shape).contiguous()
    counts = {}
    for dtype, extra, bar in (('bfloat16', TP_WIDE, BF16_BAR),
                              ('float32', {}, F32_GATE_BAR)):
        dt = getattr(torch, dtype)
        for name, shape in TP_SHAPES.items():
            hp = dp_hparams(dtype, **extra, **shape)
            hx = dict(hp, **{'nerf.mlp_backend': 'xla'})
            W, F = hp['nerf.mlp.net_width'], xyz_features(hp)
            params = jax_params_to_torch(
                flax_tree(MipNeRFSystem(hp, device=dev), seed=0), device=dev)
            with contextlib.redirect_stdout(io.StringIO()):
                systems = {'xla model 1': MipNeRFSystem(hx, device=dev),
                           'model 2': MipNeRFSystem(
                               hp, mesh=create_mesh(2, 2, device=dev))}
            got = {k: step_from(s, params, rays, pixels)
                   for k, s in systems.items()}
            loss, grads, update, c, routes = got['model 2']
            l1, g1, d1, c1 = got['xla model 1'][:4]
            where = f'phase 9f {dtype} width {W} {name} model 2'
            if any(c1.values()):
                raise AssertionError(f'{where}: xla launched {c1}')
            names = list(params)
            loss_rel = abs(loss - l1) / abs(l1)
            step_err, step_leaf = leaf_rel_err(update, d1, names)
            grad_err, grad_leaf = leaf_rel_err(grads, g1, names)
            n = check_tp_launches(c, routes, hp, dt, 1, 2, where)
            dims = pair_dims(hp, 2)
            boundary = [w for w in dims[1:] if w[0] == W + F]
            order = list(systems)
            fns = {k: s.make_train_many() for k, s in systems.items()}
            states = {k: s.init_state(params=params)
                      for k, s in systems.items()}
            times, peaks = {k: [] for k in order}, {}
            for which in order + order[::-1]:
                states[which], aux, sec, peak = train_run(
                    fns[which], states[which], stack, pix)
                times[which].append(sec * 1e3 / 2)
                peaks[which] = max(peaks.get(which, 0.0), peak)
            log(f'[tp] 9f {dtype} width {W} {name} ({shape}): model 2 vs xla '
                f'model 1, one step: loss {loss:.7f} vs {l1:.7f} (rel '
                f'{loss_rel:.2e}); gradients max leaf rel err {grad_err:.3e} '
                f'({grad_leaf}), bar {bar}; update {step_err:.3e} '
                f'({step_leaf}; not gated); pairs {dims}, boundary pair '
                f'{boundary or "none"} on {pair_kernel(dt, *dims[-1])[1]}; '
                f'pair launches {n} + {n}; ms/step of 2-step calls '
                f'{ {k: [round(t, 3) for t in v] for k, v in times.items()} };'
                f' peak GiB { {k: round(v, 3) for k, v in peaks.items()} }')
            if grad_err > bar or (dtype == 'float32' and loss_rel > 1e-5):
                raise AssertionError(f'{where} disagrees with xla model 1')
            counts[f'9f {dtype} {name} model 2 step'] = c
            del systems, fns, states, params
            torch.cuda.empty_cache()
    log(f'[tp] phase 9f: {time.perf_counter() - t_phase:.1f} s')
    return counts


def tp_run_args(root):
    """cli.train's command line of phase 9e: bf16 pallas_lean_save at lego
    width, TP_RUN_RAYS rays a step, num_devices 2 parallel.model_axis 2,
    dispatches of DP_K steps, one validation (one view) and one checkpoint
    at TP_STEPS."""
    opts = {'train.compute_dtype': 'bfloat16',
            'nerf.mlp_backend': 'pallas_lean_save', 'train.randomized': True,
            'optimizer.lr_delay_steps': 0, 'num_devices': 2,
            'parallel.model_axis': 2, 'exp_name': 'tp',
            'train.batch_size': TP_RUN_RAYS,
            'train.steps_per_call': DP_K, 'val.check_interval': TP_STEPS,
            'val.sample_num': 1}
    return (['--data_path', os.path.join(root, 'scene'), '--out_dir',
             os.path.join(root, 'out'), '--dataset_name', 'blender',
             '--max_steps', str(TP_STEPS)]
            + [str(x) for kv in opts.items() for x in kv])


def tp_worker(rank: int, port: int, root: str) -> int:
    """One process of phase 9e (chip_smoke.py --tp-worker RANK PORT ROOT):
    joins a gloo group of 2 processes on cuda:0 (NCCL takes no two ranks
    on one device), then cli.train's main on root/args.json, which finds
    the group and lays the 2 processes out as data 1 x model 2, starting
    or resuming; its pair launches on their route, and none of the lean
    training kernels; its state's bytes (parameters and both Adam moments,
    counted from the tensors) equal the split's table's count of its
    panels; writes root/rank<r>.npz (its panels of the parameters) and
    root/rank<r>.json (launches, fit_stats, the bytes, memory allocated
    after the state's set-up)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    maybe_initialize_distributed(
        {'parallel.multi_host': True,
         'parallel.coordinator_address': f'localhost:{port}',
         'parallel.num_processes': 2, 'parallel.process_id': rank},
        device='cuda', timeout_s=DP_TIMEOUT, backend='gloo')
    with open(os.path.join(root, 'args.json')) as f:
        args = json.load(f)
    after_init = []
    init_state = system_mod.MipNeRFSystem.init_state

    def counted_init(self, *a, **k):
        state = init_state(self, *a, **k)
        torch.cuda.synchronize()
        after_init.append(torch.cuda.memory_allocated())
        return state

    system_mod.MipNeRFSystem.init_state = counted_init
    km.reset_launches()
    system, state = train_cli.main(args)          # it leaves the group
    torch.cuda.synchronize()
    counts = dict(km.launches)
    mesh = system.mesh
    if not mesh.distributed or mesh.shape != {'data': 1, 'model': 2}:
        raise AssertionError(f'rank {rank}: mesh {mesh!r}')
    hp = system.hparams
    n = len(pair_dims(hp, 2)) * hp['nerf.num_levels'] * \
        system.fit_stats['steps']
    W = hp['nerf.mlp.net_width']
    check_pair_routes(torch.bfloat16, f'phase 9e rank {rank}', (W, W // 2, W),
                      True, tp_pair_fwd=n, tp_pair_bwd=n)
    if counts['lean_save_fwd'] or counts['lean_param_grads']:
        raise AssertionError(f'phase 9e rank {rank}: the lean training '
                             f'kernels ran under the model axis: {counts}')
    params = list(state['params'].values())
    opt = state['opt_state'].state
    held = [t.numel() * t.element_size() for t in params] + [
        opt[p][k].numel() * opt[p][k].element_size() for p in params
        for k in ('exp_avg', 'exp_avg_sq')]
    table, whole = (12 * c for c in system.state_numel())
    if sum(held) != table:
        raise AssertionError(f'phase 9e rank {rank}: the state holds '
                             f'{sum(held)} bytes, its panels {table}')
    log(f'[tp] 9e rank {rank}: parameters + 2 Adam moments {sum(held)} B '
        f'(the table: {table} of the whole {whole}); memory_allocated after '
        f'the state\'s set-up {after_init} B')
    np.savez(os.path.join(root, f'rank{rank}.npz'),
             **{k: v.detach().cpu().numpy()
                for k, v in state['params'].items()})
    with open(os.path.join(root, f'rank{rank}.json'), 'w') as f:
        json.dump({'launches': counts, 'fit_stats': system.fit_stats,
                   'state_bytes': sum(held), 'table_bytes': table,
                   'whole_bytes': whole, 'after_init': after_init}, f)
    return 0


def tp_run(root, dev):
    """Phase 9e: cli.train over 2 gloo processes on the one card
    (num_devices 2 parallel.model_axis 2, started as phase 9b starts its
    workers), TP_STEPS bf16 steps on the sphere scene of DP_SCENE, each
    process holding its panels of the parameters and Adam moments (their
    bytes, counted from the tensors, the table's count; memory allocated
    after the state's set-up printed): the checkpoint holds whole tensors
    (its parameters and moments at the one-device shapes), of which each
    rank's final parameters are its panels bit for bit; within BF16_BAR of
    the single-process data 1 x model 2 fit of the same steps (largest leaf
    rel err of the update), the loss falls, rank 0 alone wrote the
    checkpoint, the CSV row and the log lines.  Then a resume of one
    dispatch (DP_K steps) over 2 processes from that checkpoint (each
    slicing its panels of the parameters and both moments) against the
    unbroken single-process state going on over the same dispatch, the
    update within BF16_BAR; then cli.eval of the checkpoint in one process
    (the model axis dropped): finite PSNR and SSIM.  -> rank 0's launch
    counts."""
    t_phase = time.perf_counter()
    scene = make_sphere_scene(os.path.join(root, 'scene'), **DP_SCENE)
    args = tp_run_args(root)
    with open(os.path.join(root, 'args.json'), 'w') as f:
        json.dump(args, f)
    texts, ranks, infos = run_script_workers('--tp-worker', 2, root,
                                             same=False)
    t_workers = time.perf_counter() - t_phase
    hp = config.default()
    config.merge_from_list(hp, args[8:])
    names = sorted(ranks[0])
    out = os.path.join(root, 'out')
    ckpt_dir = os.path.join(out, 'ckpt', 'tp')
    with contextlib.redirect_stdout(io.StringIO()):
        single = MipNeRFSystem(hp, mesh=create_mesh(2, 2, device=dev))
    init = single.init_params()
    # The checkpoint holds whole tensors; each rank's panels are its own.
    _, host = CheckpointManager(ckpt_dir, write=False).restore_last()
    moments = host['opt_state']['state']
    panels = [system_mod._Panels(single.model.mlp, Mesh(1, 2, dev, True, r))
              for r in range(2)]
    for i, k in enumerate(init):
        shapes = {tuple(host['params'][k].shape), tuple(init[k].shape),
                  tuple(moments[i]['exp_avg'].shape),
                  tuple(moments[i]['exp_avg_sq'].shape)}
        if len(shapes) != 1:
            raise AssertionError(f'phase 9e: the checkpoint\'s {k} is '
                                 f'{shapes}, not whole')
        for r in range(2):
            if not np.array_equal(ranks[r][k], panels[r].local(
                    k, host['params'][k]).numpy()):
                raise AssertionError(f'phase 9e: rank {r}\'s {k} is not its '
                                     f'panel of the checkpoint\'s')
    with contextlib.redirect_stdout(io.StringIO()):
        state = single.fit(scene, 'blender', os.path.join(root, 'single'),
                           max_steps=TP_STEPS, verbose=False)
    err, leaf = leaf_rel_err(
        [host['params'][k] - init[k].cpu() for k in names],
        [state['params'][k].detach().cpu() - init[k].cpu() for k in names],
        names)
    stats = infos[0]['fit_stats']
    with open(os.path.join(out, 'logs', 'tp', 'val_history.csv')) as f:
        rows = f.read().split()[1:]
    ckpts = {k: os.listdir(os.path.join(ckpt_dir, k))
             for k in ('best', 'last')}
    step_lines = [t.count(f'/{TP_STEPS} loss=') for t in texts]
    system_lines = [t.count('Megatron pairs') for t in texts]
    # The resume: 2 processes from the checkpoint, against the unbroken
    # single-process state going on over the dispatch the resumed fit
    # draws first (its batcher starts again from the seed).
    t_resume = time.perf_counter()
    resume_root = os.path.join(root, 'resume')
    os.makedirs(resume_root)
    end = TP_STEPS + DP_K
    resume_args = list(args)
    resume_args[resume_args.index('--max_steps') + 1] = str(end)
    with open(os.path.join(resume_root, 'args.json'), 'w') as f:
        json.dump(resume_args, f)
    r_texts, _, r_infos = run_script_workers('--tp-worker', 2, resume_root,
                                             same=False)
    _, r_host = CheckpointManager(ckpt_dir, write=False).restore_last()
    start = {k: v.detach().cpu() for k, v in state['params'].items()}
    single.setup(scene, 'blender', prefetch=0, steps_per_call=DP_K)
    try:
        rays, pixels = next(single.batcher)
    finally:
        single.batcher.close()
    state = single.make_train_many()(state, rays, pixels, int(hp['seed']))[0]
    r_err, r_leaf = leaf_rel_err(
        [r_host['params'][k] - start[k] for k in names],
        [state['params'][k].detach().cpu() - start[k] for k in names], names)
    resumed = [t.count(f'at step {TP_STEPS}') for t in r_texts]
    t_resume = time.perf_counter() - t_resume
    km.reset_launches()
    with contextlib.redirect_stdout(io.StringIO()):
        summary = eval_cli.main(['--ckpt', ckpt_dir, '--data', scene,
                                 '--out_dir', os.path.join(root, 'eval'),
                                 '--scale', '1', '--no_video'])
    psnr, ssim = (float(v) for v in summary.split(' | ')[:2])
    eval_counts = {k: v for k, v in km.launches.items() if v}
    step_ms = stats['steps'] and TP_RUN_RAYS / stats['rays_per_sec'] * 1e3
    memory = [{k: info[k] for k in ('state_bytes', 'table_bytes',
                                    'whole_bytes', 'after_init')}
              for info in infos]
    log(f'[tp] 9e cli.train over 2 gloo processes on cuda:0 (data 1 x '
        f'model 2), {TP_STEPS} steps of {TP_RUN_RAYS} rays bf16 '
        f'pallas_lean_save: {t_workers:.1f} s with start-up; {stats["rays_per_sec"]:,.0f} '
        f'rays/s over the training time ({step_ms:.2f} ms/step); loss '
        f'{stats["loss_first"]:.5f} -> {stats["loss_last"]:.5f}; each rank '
        f'its panels of the checkpoint\'s whole tensors; state per rank '
        f'(parameters + 2 Adam moments, bytes counted; the table\'s; the '
        f'whole; memory_allocated after set-up) {memory}, share '
        f'{memory[0]["state_bytes"] / memory[0]["whole_bytes"]:.4f}; vs the '
        f'single-process data 1 x model 2 fit: max leaf '
        f'rel err of the update {err:.3e} ({leaf}, bar {BF16_BAR}); '
        f'checkpoints {ckpts}, CSV rows {rows}, log lines per rank '
        f'{step_lines}, system lines {system_lines}; rank 0 launches '
        f'{ {k: v for k, v in infos[0]["launches"].items() if v} }; '
        f'resume of {DP_K} steps over 2 processes ({resumed} '
        f'resumed lines; rank 0 launches '
        f'{ {k: v for k, v in r_infos[0]["launches"].items() if v} }) vs the '
        f'unbroken single-process state: max leaf rel err of the update '
        f'{r_err:.3e} ({r_leaf}, bar {BF16_BAR}), {t_resume:.1f} s; '
        f'cli.eval in one process: PSNR {psnr:.3f} SSIM {ssim:.4f}, '
        f'launches {eval_counts}')
    if err > BF16_BAR:
        raise AssertionError('phase 9e: the run disagrees with the '
                             'single-process mesh')
    if r_err > BF16_BAR or resumed[0] != 1 or \
            r_infos[0]['fit_stats']['steps'] != DP_K:
        raise AssertionError('phase 9e: the resume disagrees with the '
                             'unbroken single-process state')
    if not stats['loss_last'] < stats['loss_first']:
        raise AssertionError(f'phase 9e: the loss did not fall: {stats}')
    if ckpts != {'best': [str(TP_STEPS)], 'last': [str(TP_STEPS)]} or \
            [r.split(',')[0] for r in rows] != [str(TP_STEPS)] or \
            step_lines[0] < 1 or any(step_lines[1:]) or \
            system_lines != [1, 0]:
        raise AssertionError('phase 9e: the files or log lines are not '
                             'rank 0\'s alone')
    if not (np.isfinite(psnr) and np.isfinite(ssim)):
        raise AssertionError(f'phase 9e: cli.eval gave {summary}')
    log(f'[tp] phase 9e: {time.perf_counter() - t_phase:.1f} s')
    return infos[0]['launches']


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

    pair_lib = _build.load('tp_pair')
    pair_lib.tp_pair_wg_smem.restype = ctypes.c_longlong
    log(f'[build]   tp_pair_wg_kernel at a local width of 512: '
        f'{pair_lib.tp_pair_wg_smem(512, 1)} B bf16, '
        f'{pair_lib.tp_pair_wg_smem(512, 0)} B f32 (of 232448)')
    for dims in ((96, 512, 1024), (1024, 512, 1024), (96, 64, 256),
                 (256, 64, 256), TP_MMA_SHAPE[1:], (40, 192, 320),
                 (96, 576, 1024), (96, 512, 1000)):
        for dt, flag in ((torch.bfloat16, 1), (torch.float32, 0)):
            lib = bool(pair_lib.tp_pair_wg_route(*dims, flag))
            mirror = (kt.pair_sm90_route if flag else kt.pair_tf32_route)(
                dt, *dims)
            if lib != mirror:
                raise AssertionError(f'the pair route at {dims} {dt}: the '
                                     f'library says {lib}, kernels/tp_lean.py '
                                     f'{mirror}')

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

    # The same frame through fused_mlp's forward (val.mlp_backend pallas):
    # mlp_fwd alone on the classic form of the wgmma forward of the dtype,
    # f32 against the plain frame at its bar, bf16 at the bf16 bar.
    for dtype, bar in (('float32', FRAME_BAR), ('bfloat16', BF16_BAR)):
        pallas_system = MipNeRFSystem(
            dict(hp, **{'val.mlp_backend': 'pallas',
                        'train.compute_dtype': dtype}), device=dev)
        render_frame(pallas_system, params, cam)
        km.reset_launches()
        out_p, s_pallas = render_frame(pallas_system, params, cam)
        counts_p = dict(km.launches)
        d_rgb = float(np.abs(out_p['fine_rgb'] - ref['fine_rgb']).max())
        d_acc = float(np.abs(out_p['acc'] - ref['acc']).max())
        log(f'[slice] val.mlp_backend pallas {dtype}: {s_pallas:.3f} '
            f's/frame; launches { {k: v for k, v in counts_p.items() if v} };'
            f' vs plain max|d rgb| {d_rgb:.3e} max|d acc| {d_acc:.3e} (bar '
            f'{bar})')
        if any(counts_p[k] != (want if k == 'mlp_fwd' else 0)
               for k in counts_p):
            raise AssertionError(f'expected {want} launches of mlp_fwd alone,'
                                 f' got {counts_p}')
        check_classic_routes(hp, getattr(torch, dtype),
                             f'phase 4 pallas {dtype} frame', mlp_fwd=want)
        if d_rgb > bar or d_acc > bar or not all(
                np.all(np.isfinite(v)) for v in out_p.values()):
            raise AssertionError(f'the {dtype} pallas frame disagrees with '
                                 'the plain path')
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
    # The same four kernels for the models of CLASSIC_SHAPES: with no view
    # layer (the NV forms of the wgmma kernels), and with two density heads
    # (the mma.sync kernels, both forms).
    shapes = {}
    for key, (extra, label) in CLASSIC_SHAPES.items():
        hp_c = dict(hp, **extra)
        params_c = jax_params_to_torch(
            flax_tree(MipNeRFSystem(hp_c, device=dev), seed=0), device=dev)
        results.update(compare_classic_kernels(params_c, hp_c, dev, label))
        shapes[key] = hp_c, params_c
    results.update(compare_ipe_kernels(hp, dev))
    results.update(compare_pair_kernels(hp, dev))
    tp_counts = tp_slice(hp, params, dev)
    train_counts = train_slice(hp, params, dev)
    classic_counts = {
        key: classic_slice(hp_c, params_c, dev, CLASSIC_SHAPES[key][1][1:-1])
        for key, (hp_c, params_c) in shapes.items()}
    del shapes
    run_counts = whole_run(hp)
    with tempfile.TemporaryDirectory() as root:
        ckpt_dir, new_paths = multiscale_run(hp, dev, root)
        new_paths['orbit_video'] = orbit_video(hp, ckpt_dir, root)
    new_paths.update(benches(hp))

    # Phases 8a-8d: the unbounded-360 path at full width, and the quality
    # smoke.
    t_new = time.perf_counter()
    hp_360 = real360_hparams()
    params_360 = jax_params_to_torch(
        flax_tree(MipNeRFSystem(hp_360, device=dev), seed=0), device=dev)
    results.update(compare_real360_kernels(params_360, hp_360, dev))
    real360_gates(hp_360, params_360, dev)
    with tempfile.TemporaryDirectory() as root:
        real360_counts = real360_run(root)
    quality_run(smi)
    log(f'[real360] phases 8a-8d: {time.perf_counter() - t_new:.1f} s')

    # Phase 8e: the multi-scale tools through the CLIs.
    t_tools = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        tools_counts = tools_run(root, smi)
    log(f'[tools] phase 8e: {time.perf_counter() - t_tools:.1f} s')

    # Phase 9: data parallelism through the system.
    t_dp = time.perf_counter()
    dp_counts = {f'9a {dtype} data-{DP_SHARDS} step': c
                 for dtype, c in dp_step(params, dev)[0].items()}
    with tempfile.TemporaryDirectory() as root:
        dp_counts['9b rank 0 fit'] = dp_run(root, dev)
    log(f'[dp] phase 9: {time.perf_counter() - t_dp:.1f} s')

    # Phases 9c-9f: tensor parallelism through the system.
    t_tp = time.perf_counter()
    tp_counts_sys = tp_step(params, dev)[0]
    tp_counts_sys.update(tp_wide_step(dev))
    with tempfile.TemporaryDirectory() as root:
        tp_counts_sys['9e rank 0 fit'] = tp_run(root, dev)
    tp_counts_sys.update(tp_shapes_step(dev))
    log(f'[tp] phases 9c-9f: {time.perf_counter() - t_tp:.1f} s')
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
        # Device times (torch.profiler) of the kernels whose events read
        # the host: at the phase's shape, lean_composite's also at a
        # training level's rays, ipe_moments' also at a render chunk.
        for key in ('device_ms', 'device_ms_train', 'device_ms_chunk'):
            if key in r:
                kernels[-1][key] = r[key]
        # The kernel's launches on the paths of phases 7b-7d, and of
        # phase 9 (a data-2 step of 9a in each dtype, rank 0's fit in 9b).
        kernels[-1]['launches_new_paths'] = {
            path: c[name] for path, c in new_paths.items() if c[name]}
        kernels[-1]['launches_dp'] = {
            path: c[name] for path, c in dp_counts.items() if c.get(name)}
        # And on the tensor-parallel paths of phases 9c-9f (a step of each
        # mesh and shape, rank 0's fit).
        kernels[-1]['launches_tp'] = {
            path: c[name] for path, c in tp_counts_sys.items()
            if c.get(name)}
        # And in the stages of the multi-scale tools (phase 8e).
        kernels[-1]['launches_tools'] = {
            stage: c[name] for stage, c in tools_counts.items()
            if c.get(name)}
        rb = results.get((name, 'bf16'))
        if rb is not None:     # the compute dtype of the bf16 steps
            kernels[-1]['bf16'] = {k: rb[k] for k in (
                'err', 'ms', 'plain_ms', 'bound_ms', 'library_ms')}
            kernels[-1]['bf16']['share'] = rb['bound_ms'] / rb['ms']
            # The bf16 numbers' wgmma kernels: the lean forms, and the
            # classic ones of fused_mlp's kernels.
            on16 = classic_route(hp, torch.bfloat16)
            if (name in CLASSIC_FWD and on16[0]) or (
                    name in km.routes and name not in CLASSIC_FWD
                    and sm90_route(hp, torch.bfloat16)):
                kernels[-1]['bf16']['kernel'] = 'lean_fwd_sm90_kernel'
                kernels[-1]['bf16']['source'] = \
                    'mipnerf_pl_tpu_torch/csrc/lean_fwd_sm90.cuh'
            if (name in CLASSIC_CHAIN and on16[1]) or (
                    name in km.chain_routes and name not in CLASSIC_CHAIN
                    and chain_route(hp, torch.bfloat16)[0]):
                kernels[-1]['bf16']['chain'] = 'lean_chain_sm90_kernel'
                kernels[-1]['bf16']['chain_source'] = \
                    'mipnerf_pl_tpu_torch/csrc/lean_chain_sm90.cuh'
            if name in km.wgrad_sm90_routes:
                kernels[-1]['bf16']['wgrad'] = 'wgrad_sm90_kernel'
                kernels[-1]['bf16']['wgrad_source'] = \
                    'mipnerf_pl_tpu_torch/csrc/lean_wgrad_sm90.cuh'
            if 'mm_ms' in rb:     # torch.mm on its weight-gradient products
                kernels[-1]['bf16']['wgrad_mm_ms'] = rb['mm_ms']
        # The f32 numbers' wgmma kernels (the line's own 'source' is the
        # library the wrapper launches, which holds them).
        on32 = classic_route(hp, torch.float32)
        if (name in km.routes and name not in CLASSIC_FWD
                and tf32_route(hp, torch.float32)) or (
                name in CLASSIC_FWD and on32[0]):
            kernels[-1]['kernel'] = 'lean_fwd_tf32_kernel'
            kernels[-1]['kernel_source'] = \
                'mipnerf_pl_tpu_torch/csrc/lean_fwd_tf32.cuh'
        if (name in km.chain_routes and name not in CLASSIC_CHAIN
                and chain_route(hp, torch.float32)[1]) or (
                name in CLASSIC_CHAIN and on32[1]):
            kernels[-1]['chain'] = 'lean_chain_tf32_kernel'
            kernels[-1]['chain_source'] = \
                'mipnerf_pl_tpu_torch/csrc/lean_chain_tf32.cuh'
        if name in km.wgrad_tf32_routes and km.wgrad_tf32_route(
                torch.float32, *lego_wgrad_range(hp)):
            kernels[-1]['wgrad'] = 'wgrad_tf32_kernel'
            kernels[-1]['wgrad_source'] = \
                'mipnerf_pl_tpu_torch/csrc/lean_wgrad_tf32.cuh'
        if name in ('tp_pair_fwd', 'tp_pair_bwd'):
            # Both dtypes ran on tp_pair_wg_kernel at the slice's widths
            # (check_pair_routes); beside the later pair, the first pair and
            # the mma.sync kernels at TP_MMA_SHAPE (1 forward and 2
            # backward calls a dtype in phase 5).
            src = 'mipnerf_pl_tpu_torch/csrc/tp_pair_sm90.cuh'
            kernels[-1].update(kernel='tp_pair_wg_kernel<f32> (3xTF32)',
                               kernel_source=src)
            kernels[-1]['bf16'].update(kernel='tp_pair_wg_kernel<bf16>',
                                       kernel_source=src)
            for suffix, key in (('[first pair]', 'first_pair'),
                                ('[mma.sync]', 'mma_sync')):
                entry = {}
                for tag in ('f32', 'bf16'):
                    rn = results[(name + suffix, tag)]
                    part = {k: rn[k] for k in ('err', 'ms', 'plain_ms',
                                               'bound_ms', 'bound_by',
                                               'library_ms')}
                    part['share'] = rn['bound_ms'] / rn['ms']
                    if tag == 'f32':
                        entry.update(part)
                    else:
                        entry['bf16'] = part
                kernels[-1][key] = entry
            kernels[-1]['mma_sync'].update(
                kernel=name + '_kernel', source=source,
                shape=list(TP_MMA_SHAPE),
                launches=2 * (1 if name == 'tp_pair_fwd' else 2))
        # #3 / #4a at the real360 level (F = 42, phase 8a), with their
        # launches in phase 8c's run and the kernels each dtype took.
        if (name + REAL360_TAG, 'f32') in results:
            entry = {'shape': [TRAIN_RAYS, hp_360['nerf.num_samples'],
                               xyz_features(hp_360)],
                     'launches': real360_counts[name]}
            for dt, tag in ((torch.float32, 'f32'), (torch.bfloat16, 'bf16')):
                rn = results[(name + REAL360_TAG, tag)]
                part = {k: rn[k] for k in ('err', 'ms', 'plain_ms', 'bound_ms',
                                           'bound_by', 'library_ms')}
                part['share'] = rn['bound_ms'] / rn['ms']
                part.update(real360_kernel_names(name, hp_360, dt))
                if dt == torch.float32:
                    entry.update(part)
                else:
                    entry['bf16'] = part
            kernels[-1]['real360'] = entry
        if 'wgrad' in r:
            kernels[-1]['wgrad_ms'] = r['wgrad']
        if 'mm_ms' in r:
            kernels[-1]['wgrad_mm_ms'] = r['mm_ms']
        # fused_mlp's kernels for each model of CLASSIC_SHAPES (phase 5's
        # numbers, phase 6's launches), f32 and under 'bf16' bf16, with the
        # device kernels each took.
        for key, (extra, label) in CLASSIC_SHAPES.items():
            if (name + label, 'f32') not in results:
                continue
            hp_c = dict(hp, **extra)
            entry = {}
            for dt, tag in ((torch.float32, 'f32'), (torch.bfloat16, 'bf16')):
                rn = results[(name + label, tag)]
                part = {k: rn[k] for k in ('err', 'ms', 'plain_ms', 'bound_ms',
                                           'bound_by')}
                part['share'] = rn['bound_ms'] / rn['ms']
                part.update(classic_kernel_names(name, hp_c, dt))
                part['launches'] = \
                    classic_counts[key][str(dt)[len('torch.'):]][name]
                if tag == 'f32':
                    entry.update(part)
                else:
                    entry['bf16'] = part
            kernels[-1][key] = entry
    log(f'[done] wall {time.perf_counter() - START:.1f} s')
    print(json.dumps({'kernels': kernels}))
    print(smi_line())
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    if sys.argv[1:2] == ['--dp-worker']:
        sys.exit(dp_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    if sys.argv[1:2] == ['--tp-worker']:
        sys.exit(tp_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    sys.exit(main())
