"""One process a device: how the CLIs start and join a parallel run.

Counterpart of the JAX package's train.py:38-49, where one controller sees
every chip and `parallel.multi_host` joins the hosts' controllers.  Here a
process drives one device, so a CLI whose hparams ask for n > 1 devices
(`requested_devices`; `num_devices: 0` = every visible card) and that is
not yet in a process group starts n workers of itself (`run_workers`): the
same command line, each told its place through `WORKER_ENV`, NCCL on
`cuda:r` or gloo with `--device cpu`, over a free localhost port.  The
parent waits for them and returns the first non-zero exit code, stopping
the others.  A worker, or a process of a multi-host run
(`parallel.multi_host` with `parallel.coordinator_address`,
`parallel.num_processes`, `parallel.process_id`), joins its group with
`join_group` and drives card `process_id % torch.cuda.device_count()`.
With `parallel.model_axis` m the n workers form a (n / m, m) mesh: the
model ranks of one data shard read the same rows of each batch (the
batcher's shard is the data rank).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from mipnerf_pl_tpu_torch.parallel.mesh import (maybe_initialize_distributed,
                                                model_axis, multi_host,
                                                requested_devices)

# "host:port,num_processes,process_id" of a worker that run_workers started.
WORKER_ENV = 'MIPNERF_TORCH_WORKER'
# The keys that place a process in a multi-host run.
PROCESS_KEYS = ('parallel.multi_host', 'parallel.coordinator_address',
                'parallel.num_processes', 'parallel.process_id')


def checkpoint_hparams(ckpt_path: str, opts: Sequence[str] = ()) -> dict:
    """The hparams a render CLI runs with: the checkpoint's, less
    PROCESS_KEYS (they placed the processes that trained it) and less its
    model axis (a render splits rows over `data` only: a run of n devices
    under `parallel.model_axis` m renders on n / m, one card for data 1),
    with `opts` (key value ...) merged over them, which may ask for a model
    axis again."""
    from mipnerf_pl_tpu_torch import config
    from mipnerf_pl_tpu_torch.train.ckpt import load_hparams

    hparams = load_hparams(ckpt_path)
    for key in PROCESS_KEYS:
        hparams[key] = config.DEFAULTS[key]
    m = model_axis(hparams)
    if m > 1:
        hparams['num_devices'] = requested_devices(hparams) // m
        hparams['parallel.model_axis'] = 1
    if opts:
        config.merge_from_list(hparams, list(opts))
    return hparams


def workers_to_start(hparams, device) -> int:
    """How many workers a CLI must start: 0 when this process runs the job
    itself (one device, a worker, or a multi-host process), else the device
    count the hparams ask for.  Raises when more CUDA devices are asked for
    than this host has."""
    if started_worker() or dist.is_initialized() or multi_host(hparams):
        return 0
    n = requested_devices(hparams)
    on_cpu = device is not None and torch.device(device).type == 'cpu'
    if on_cpu:
        return n if n > 1 else 0
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n > visible and n > 1:
        raise ValueError(
            f'{n} data shards asked for (num_devices / num_gpus) and this '
            f'host has {visible} CUDA devices: one process drives one '
            'device (--device cpu runs them on the CPU over gloo)')
    n = n or visible
    return n if n > 1 else 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def run_workers(module: str, argv: Sequence[str], n: int,
                poll_s: float = 0.2) -> int:
    """Start `python -m module argv` n times, worker r told its place in
    WORKER_ENV, and wait; -> 0, or the first non-zero exit code, after
    which the other workers are killed (none is left running when this
    returns or raises).  Unless OMP_NUM_THREADS is set, the workers share
    the host's cores (each takes 1/n of them, as torchrun's would)."""
    port = _free_port()
    # The workers import this checkout's packages, wherever they start.
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env['PYTHONPATH'] = os.pathsep.join(
        [root] + [p for p in [env.get('PYTHONPATH')] if p])
    env.setdefault('OMP_NUM_THREADS', str(max(1, (os.cpu_count() or 1) // n)))
    procs = []
    try:
        for r in range(n):
            env[WORKER_ENV] = f'localhost:{port},{n},{r}'
            procs.append(subprocess.Popen(
                [sys.executable, '-m', module, *argv], env=env))
        while True:
            codes = [p.poll() for p in procs]
            failed = [c for c in codes if c not in (None, 0)]
            if failed:
                return failed[0]
            if all(c == 0 for c in codes):
                return 0
            time.sleep(poll_s)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def started_worker() -> bool:
    """True in a worker that run_workers started."""
    return bool(os.environ.get(WORKER_ENV))


def join_group(hparams, device) -> Optional[torch.device]:
    """Join this process's group, if it is a worker of run_workers or a
    process of a multi-host run, and -> the device it drives: the CPU with
    `device` cpu (gloo), else card process_id % torch.cuda.device_count()
    (NCCL).  Otherwise -> `device` as given, with no group."""
    spec = os.environ.get(WORKER_ENV)
    if spec:
        address, n, r = spec.split(',')
        keys = {'parallel.multi_host': True,
                'parallel.coordinator_address': address,
                'parallel.num_processes': int(n),
                'parallel.process_id': int(r)}
    elif multi_host(hparams):
        keys = hparams
    else:
        return None if device is None else torch.device(device)
    on_cpu = device is not None and torch.device(device).type == 'cpu'
    if not dist.is_initialized():
        maybe_initialize_distributed(keys, device='cpu' if on_cpu else 'cuda')
    if on_cpu:
        return torch.device('cpu')
    local = dist.get_rank() % torch.cuda.device_count()
    torch.cuda.set_device(local)
    return torch.device('cuda', local)


def leave_group() -> None:
    """Destroy the process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()
