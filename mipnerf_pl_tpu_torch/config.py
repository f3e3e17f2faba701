"""Flat dotted-key config schema.

Counterpart of mipnerf_pl_tpu/config.py.  The default schema is the
flattened form of mipnerf_pl_tpu/configs/default.yaml, held here as a
Python dict so that importing the port needs no YAML parser; `load` and
`save` import `yaml` only when they touch a file.  The merge order of
`parse_args` is defaults <- --config file <- the positional `opts`
key/value remainder <- the argparse namespace's other keys.  INERT_KEYS are
accepted so the same configs load, and have no effect in the port; setting
one warns.
"""

from __future__ import annotations

import argparse
import copy
import warnings
from ast import literal_eval

DEFAULTS = {
    'seed': 4,
    'num_devices': 0,
    'num_gpus': 0,
    'exp_name': 'exp',
    'train.batch_size': 3072,
    'train.batch_type': 'all_images',
    'train.num_work': 4,
    'train.randomized': True,
    'train.white_bkgd': True,
    'train.compute_dtype': 'float32',
    'train.donate_buffers': True,
    'train.packed_adam': True,
    'val.batch_size': 1,
    'val.batch_type': 'single_image',
    'val.num_work': 4,
    'val.randomized': False,
    'val.white_bkgd': True,
    'val.check_interval': 10000,
    'val.chunk_size': 8192,
    'val.sample_num': 4,
    'val.fetch_dtype': 'float16',
    'val.mlp_backend': 'auto',
    'nerf.num_samples': 128,
    'nerf.num_levels': 2,
    'nerf.resample_padding': 0.01,
    'nerf.stop_resample_grad': True,
    'nerf.use_viewdirs': True,
    'nerf.disparity': False,
    'nerf.ray_shape': 'cone',
    'nerf.min_deg_point': 0,
    'nerf.max_deg_point': 16,
    'nerf.deg_view': 4,
    'nerf.density_activation': 'softplus',
    'nerf.density_noise': 0.0,
    'nerf.density_bias': -1.0,
    'nerf.rgb_activation': 'sigmoid',
    'nerf.rgb_padding': 0.001,
    'nerf.disable_integration': False,
    'nerf.append_identity': True,
    'nerf.unbounded': False,
    'nerf.ipe_backend': 'xla',
    'nerf.mlp_backend': 'xla',
    'nerf.fuse_render': False,
    'nerf.channel_major': True,
    'nerf.lean_input_cast': False,
    'nerf.fuse_encode': False,
    'nerf.fast_encode_math': True,
    'nerf.pallas_encode': False,
    'nerf.mxu_cumsum': True,
    'nerf.mlp.net_depth': 8,
    'nerf.mlp.net_width': 256,
    'nerf.mlp.net_depth_condition': 1,
    'nerf.mlp.net_width_condition': 128,
    'nerf.mlp.net_activation': 'relu',
    'nerf.mlp.skip_index': 4,
    'nerf.mlp.num_rgb_channels': 3,
    'nerf.mlp.num_density_channels': 1,
    'optimizer.lr_init': 0.0005,
    'optimizer.lr_final': 5e-06,
    'optimizer.lr_delay_steps': 2500,
    'optimizer.lr_delay_mult': 0.01,
    'optimizer.max_steps': 1000000,
    'loss.disable_multiscale_loss': False,
    'loss.coarse_loss_mult': 0.1,
    'loss.distloss_mult': 0.01,
    'checkpoint.resume_path': None,
    'checkpoint.save_top_k': 2,
    'checkpoint.save_last': True,
    'checkpoint.auto_resume': True,
    'parallel.model_axis': 1,
    'parallel.multi_host': False,
    'parallel.coordinator_address': None,
    'parallel.num_processes': None,
    'parallel.process_id': None,
    'data.factor': None,
}


def _parse_dict(d, d_out=None, prefix=''):
    """Flatten nested dicts to dotted keys with literal_eval coercion."""
    if d is None:
        return {}
    d_out = d_out if d_out is not None else {}
    for k, v in d.items():
        if isinstance(v, dict):
            _parse_dict(v, d_out, prefix=prefix + k + '.')
        else:
            if isinstance(v, str):
                try:
                    v = literal_eval(v)
                except (ValueError, SyntaxError):
                    pass  # genuinely a string
            if isinstance(v, list):
                v = tuple(v)
            d_out[prefix + k] = v
    return d_out


def default() -> dict:
    """A fresh copy of the full default schema."""
    return copy.deepcopy(DEFAULTS)


def load(fname: str) -> dict:
    """Read a (nested) YAML config file into the flat dotted-key form."""
    import yaml
    with open(fname, 'r') as fp:
        return _parse_dict(yaml.safe_load(fp))


def merge_from_file(config: dict, fname: str) -> None:
    config.update(load(fname))


def merge_from_list(config: dict, list_merge) -> None:
    """Merge a flat [key, value, key, value, ...] list (the CLI remainder)."""
    if len(list_merge) % 2 != 0:
        raise ValueError('merge_from_list needs key/value pairs, got '
                         f'{len(list_merge)} items')
    config.update(_parse_dict(dict(zip(list_merge[0::2], list_merge[1::2]))))


# Accepted for schema parity, no effect here: the reference's DataLoader
# keys (as in the JAX package), the JAX package's TPU layout and speed
# knobs (including the packed-Adam fusion and buffer donation), and its f16
# host-fetch of render outputs (a TPU host-link trick; the port hands back
# float32).  `nerf.fast_encode_math` is live: it selects no fast
# transcendentals in the port, but gates `nerf.pallas_encode` as in JAX.
INERT_KEYS = ('train.num_work', 'val.num_work', 'val.batch_size',
              'val.fetch_dtype', 'nerf.channel_major', 'nerf.lean_input_cast',
              'nerf.mxu_cumsum', 'train.packed_adam', 'train.donate_buffers')


def warn_inert_keys(config: dict) -> None:
    """Warn for every INERT_KEYS entry set to a non-default value."""
    for k in INERT_KEYS:
        if k in config and config[k] != DEFAULTS[k]:
            warnings.warn(f'config key {k!r} is accepted for schema parity '
                          'but has no effect in mipnerf_pl_tpu_torch',
                          stacklevel=2)


def parse_args(parser: argparse.ArgumentParser, argv=None) -> dict:
    """defaults <- --config file <- `opts` remainder <- argparse keys
    (`argv` None reads sys.argv)."""
    args = parser.parse_args(argv)
    config = default()
    if getattr(args, 'config', None) is not None:
        merge_from_file(config, args.config)
    if getattr(args, 'opts', None):
        merge_from_list(config, args.opts)
    for k, v in vars(args).items():
        if k not in config:
            config[k] = v
    warn_inert_keys(config)
    return config


def to_nested(config: dict) -> dict:
    """Dotted-key dict -> nested dict (for YAML round-tripping)."""
    out: dict = {}
    for k, v in config.items():
        parts = k.split('.')
        node = out
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = list(v) if isinstance(v, tuple) else v
    return out


def save(config: dict, fname: str) -> None:
    import yaml
    with open(fname, 'w') as fp:
        yaml.safe_dump(to_nested(config), fp, sort_keys=False)
