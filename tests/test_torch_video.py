"""The port's orbit video, camera paths and validation panels against the
JAX package (CPU).

`spheric_render_cameras` / `spheric_render_rays` within 1e-6 of
mipnerf_pl_tpu/data/render_path.py, and the camera form expanded on the
device (ops/camera.py camera_rays) equal to the ray form within the port at
test_camera.py's bars; `stack_rgb`, `create_spiral_poses`,
`gen_render_path` and `normalize` against mipnerf_pl_tpu/utils/vis.py;
`vis_lr` writes its plot.  The render_video CLI on a tiny checkpoint writes
each level's frames and its video, also with --gen_video_only; the eval CLI
without --no_video writes videos; validate's TensorBoard panels are JAX's
stack_rgb / visualize_depth of the same outputs.
"""

import os

import numpy as np
import pytest

from helpers import make_blender_scene
from mipnerf_pl_tpu.data import render_path as jrender_path
from mipnerf_pl_tpu.utils import vis as jvis
from mipnerf_pl_tpu_torch import config
from mipnerf_pl_tpu_torch.cli import eval as eval_cli
from mipnerf_pl_tpu_torch.cli import render_video as video_cli
from mipnerf_pl_tpu_torch.cli import train as train_cli
from mipnerf_pl_tpu_torch.data import render_path
from mipnerf_pl_tpu_torch.ops.camera import camera_rays
from mipnerf_pl_tpu_torch.system import MipNeRFSystem
from mipnerf_pl_tpu_torch.utils import vis

SIZE = 16
TINY = {'exp_name': 'vid', 'train.batch_size': 64, 'nerf.num_samples': 8,
        'nerf.max_deg_point': 4, 'nerf.deg_view': 2, 'nerf.mlp.net_depth': 2,
        'nerf.mlp.net_width': 32, 'nerf.mlp.net_width_condition': 16,
        'val.chunk_size': 128, 'val.sample_num': 1, 'val.check_interval': 2,
        'train.steps_per_call': 2, 'optimizer.lr_delay_steps': 0}


@pytest.mark.parametrize('scales', [1, 3])
def test_render_path_matches_jax(scales):
    kw = dict(base_focal=20.0, base_size=(16, 12), scales=scales, n_poses=3)
    rays = render_path.spheric_render_rays(**kw)
    jrays = jrender_path.spheric_render_rays(**kw)
    cams = render_path.spheric_render_cameras(**kw)
    jcams = jrender_path.spheric_render_cameras(**kw)
    assert len(rays) == len(jrays) == len(cams) == len(jcams) == 3 * scales
    for i, (r, jr, (cam, hw), (jcam, jhw)) in enumerate(
            zip(rays, jrays, cams, jcams)):
        # Scale-major: every full-resolution frame first.
        assert hw == jhw == (12 >> (i // 3), 16 >> (i // 3))
        for name in r._fields:
            np.testing.assert_allclose(getattr(r, name), getattr(jr, name),
                                       rtol=0, atol=1e-6, err_msg=name)
        for a, b in zip(cam, jcam):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                                       atol=1e-6)
        # The camera form expands to the ray form.
        dev = camera_rays(cam, *hw)
        for name in r._fields:
            np.testing.assert_allclose(getattr(dev, name).numpy(),
                                       getattr(r, name), rtol=1e-5,
                                       atol=2e-5, err_msg=name)


def test_vis_helpers_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    imgs = [rng.uniform(size=(5, 7, 3)).astype(np.float32) for _ in range(3)]
    np.testing.assert_array_equal(vis.stack_rgb(*imgs), jvis.stack_rgb(*imgs))
    assert vis.stack_rgb(*imgs).shape == (3, 3, 5, 7)
    v = rng.normal(size=3)
    np.testing.assert_array_equal(vis.normalize(v), jvis.normalize(v))
    radii = np.array([1.0, 0.5, 0.25])
    np.testing.assert_allclose(vis.create_spiral_poses(radii, 3.0, 7),
                               jvis.create_spiral_poses(radii, 3.0, 7),
                               rtol=0, atol=1e-12)
    keys = np.broadcast_to(np.eye(4), (3, 4, 4)).copy()
    keys[:, :3, :4] = vis.create_spheric_poses(4.0, 3)
    np.testing.assert_allclose(vis.gen_render_path(keys, 12),
                               jvis.gen_render_path(keys, 12), rtol=0,
                               atol=1e-12)
    out = str(tmp_path / 'lr.png')
    vis.vis_lr(lambda s: 5e-4 * 0.99 ** s, 200, out)
    assert os.path.getsize(out) > 0


@pytest.fixture(scope='module')
def ckpt(tmp_path_factory):
    """A 4-step checkpoint of a tiny model on a 16x16 Blender scene; ->
    (scene, out_dir, checkpoint directory)."""
    import contextlib
    import io
    scene = make_blender_scene(str(tmp_path_factory.mktemp('scene')),
                               n_frames=2, size=SIZE)
    out = str(tmp_path_factory.mktemp('out'))
    opts = [str(x) for kv in TINY.items() for x in kv]
    with contextlib.redirect_stdout(io.StringIO()):
        train_cli.main(['--data_path', scene, '--out_dir', out,
                        '--dataset_name', 'blender', '--max_steps', '4',
                        '--device', 'cpu'] + opts)
    return scene, out, os.path.join(out, 'ckpt', 'vid')


def test_render_video_cli(ckpt, tmp_path, capsys):
    _, _, ck = ckpt
    out = str(tmp_path)
    seconds = video_cli.main(['--ckpt', ck, '--out_dir', out, '--scale', '2',
                              '--base_size', str(SIZE), str(SIZE),
                              '--n_poses', '3', '--chunk_size', '100',
                              '--device', 'cpu'])
    assert sorted(seconds) == [1, 2] and all(len(v) == 3
                                             for v in seconds.values())
    log = capsys.readouterr().out
    root = os.path.join(out, 'render_spheric', 'vid')
    from PIL import Image
    for level in (1, 2):
        files = sorted(os.listdir(os.path.join(root, str(level))))
        assert files == [f'{i:05d}_{k}.png' for i in range(3)
                         for k in ('acc', 'dist', 'rgb')] + \
            [f'video_{level}.mov']
        assert os.path.getsize(os.path.join(root, str(level),
                                            files[-1])) > 0
        assert Image.open(os.path.join(root, str(level), files[2])).size == \
            (SIZE // level, SIZE // level)
        assert f'video_{level}.mov (' in log
    # --gen_video_only assembles the videos of frames already rendered.
    for level in (1, 2):
        os.remove(os.path.join(root, str(level), f'video_{level}.mov'))
    written = video_cli.main(['--out_dir', out, '--scale', '2',
                              '--gen_video_only', '--render_images_dir',
                              root])
    assert written == [os.path.join(root, str(level), f'video_{level}.mov')
                       for level in (1, 2)]
    assert all(os.path.getsize(p) > 0 for p in written)
    with pytest.raises(SystemExit):
        video_cli.main(['--out_dir', out, '--scale', '1', '--gen_video_only'])


def test_eval_cli_writes_videos(ckpt, tmp_path):
    scene, _, ck = ckpt
    eval_cli.main(['--ckpt', ck, '--data', scene, '--out_dir', str(tmp_path),
                   '--scale', '1', '--base_size', str(SIZE), str(SIZE),
                   '--save_image', '--chunk_size', '100', '--device', 'cpu'])
    video = tmp_path / 'test' / 'vid' / '1' / 'video_1.mov'
    assert video.stat().st_size > 0


class _Recorder:
    def __init__(self):
        self.images = {}

    def add_scalar(self, *args):
        pass

    def add_images(self, tag, value, step):
        self.images[tag] = (np.asarray(value), step)

    add_image = add_images


def test_validate_panels_match_jax(ckpt):
    """The first image's panels are JAX's stack_rgb and visualize_depth
    of the outputs the port rendered."""
    scene, _, _ = ckpt
    hp = config.default()
    hp.update(TINY)
    system = MipNeRFSystem(hp, device='cpu')
    system.setup(scene, 'blender', prefetch=0)
    system.batcher.close()
    state = system.init_state()
    writer = _Recorder()
    system.validate(state, 2, writer=writer, global_step=7)
    cam, (h, w) = system.val_dataset.camera(0)
    out = system.render_camera(state['params'], cam, h, w)
    gt = system.val_dataset[0][1][..., :3]
    panel, step = writer.images['val/GT_coarse_fine']
    assert step == 7 and panel.shape == (3, 3, h, w)
    np.testing.assert_array_equal(
        panel, jvis.stack_rgb(gt, out['coarse_rgb'], out['fine_rgb']))
    depth, step = writer.images['distance']
    assert step == 7 and depth.shape == (3, h, w)
    np.testing.assert_array_equal(
        depth, np.transpose(jvis.visualize_depth(out['distance']),
                            (2, 0, 1)))
