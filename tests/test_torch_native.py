"""The port's native batch gather (mipnerf_pl_tpu_torch/native) against
numpy and the JAX package's gather (CPU): the same rows bit for bit, of
any plain element type, the numpy path for inputs the library does not
take, a failed build that
raises, and the datasets' batches equal to the JAX datasets' sample_batch
for the same numpy Generator."""

import numpy as np
import pytest

from helpers import make_blender_scene
from mipnerf_pl_tpu.data.datasets import Blender as JBlender
from mipnerf_pl_tpu.data.datasets import Multicam as JMulticam
from mipnerf_pl_tpu.native.gather import gather_multi as jax_gather_multi
from mipnerf_pl_tpu_torch.data.convert import convert_to_nerfdata
from mipnerf_pl_tpu_torch.data.datasets import Blender, Multicam
from mipnerf_pl_tpu_torch.native import gather
from mipnerf_pl_tpu_torch.rays import Rays

# The ray fields' widths and the pixels' (origins, directions, viewdirs,
# radii, lossmult, near, far, rgb).
WIDTHS = [3, 3, 3, 1, 1, 1, 1, 3]


def _arrays(n_rows, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(n_rows, w)).astype(np.float32) for w in WIDTHS]


def _indices(rng, n_rows, n):
    """n seeded indices with duplicates and both boundaries."""
    idx = rng.integers(0, n_rows, size=n)
    idx[:6] = [0, n_rows - 1, 0, n_rows // 2, n_rows - 1, n_rows - 1]
    return idx


@pytest.mark.parametrize('n_rows,n,n_threads', [
    (100, 6, None), (10000, 3072, None), (10000, 8192, 4), (10000, 8192, 1),
    (7, 0, None)])
def test_gather_multi_equals_numpy_and_jax(n_rows, n, n_threads):
    arrays = _arrays(n_rows)
    idx = _indices(np.random.default_rng(1), n_rows, n) if n else \
        np.zeros(0, np.int64)
    got = gather.gather_multi(arrays, idx, n_threads=n_threads)
    theirs = jax_gather_multi(arrays, idx)
    assert gather.loaded() is not None
    for g, t, a in zip(got, theirs, arrays):
        assert g.dtype == np.float32 and g.shape == (n, a.shape[1])
        np.testing.assert_array_equal(g, a[idx])
        np.testing.assert_array_equal(g, t)


@pytest.mark.parametrize('dtype', [np.float64, np.int32, np.uint8, bool])
def test_gather_multi_takes_every_element_type(dtype):
    """C-contiguous 2-D arrays of any plain element type go through the
    library's one pass, beside float32 ones, and keep their dtype."""
    arrays = _arrays(40)
    arrays[1] = arrays[1].astype(np.float64)         # Blender's directions
    arrays[5] = (arrays[5] * 100).astype(dtype)
    assert all(map(gather.native_ok, arrays))
    idx = _indices(np.random.default_rng(3), 40, 5000)
    got = gather.gather_multi(arrays, idx, n_threads=3)
    for g, a in zip(got, arrays):
        assert g.dtype == a.dtype and g.flags['C_CONTIGUOUS']
        np.testing.assert_array_equal(g, a[idx])


def _other_forms(arrays):
    """arrays with one input of each form the library does not take."""
    arrays = list(arrays)
    arrays[0] = np.asfortranarray(arrays[0])
    arrays[1] = np.ascontiguousarray(np.repeat(arrays[1], 2, 1))[:, ::2]
    arrays[2] = arrays[2].astype(object)
    arrays[4] = arrays[4][:, 0]
    return arrays


@pytest.mark.parametrize('mixed', [False, True])
def test_gather_multi_takes_numpy_for_other_inputs(mixed, monkeypatch):
    """Inputs that are not C-contiguous 2-D arrays of plain elements take
    numpy indexing, with numpy's result and dtype; beside them the others
    go through the library.  With none of those the library is never
    asked for."""
    arrays = _other_forms(_arrays(50))
    if not mixed:
        arrays = [a for a in arrays if not gather.native_ok(a)]

        def refuse():
            raise AssertionError('the library was asked for')

        monkeypatch.setattr(gather, 'library', refuse)
    assert sum(map(gather.native_ok, arrays)) == (4 if mixed else 0)
    idx = _indices(np.random.default_rng(2), 50, 16)
    got = gather.gather_multi(arrays, idx)
    theirs = jax_gather_multi(arrays, idx)
    for g, t, a in zip(got, theirs, arrays):
        np.testing.assert_array_equal(g, a[idx])
        np.testing.assert_array_equal(g, t)
        assert g.dtype == a.dtype


def test_gather_multi_refuses_indices_out_of_range():
    arrays = _arrays(10)
    for idx in ([0, 10], [-1, 3]):
        with pytest.raises(IndexError):
            gather.gather_multi(arrays, np.array(idx))


def _fresh_build(monkeypatch, tmp_path):
    """A gather module state with nothing loaded and an empty build
    directory."""
    monkeypatch.setattr(gather, '_LIB', None)
    monkeypatch.setattr(gather, '_LIB_PATH', None)
    monkeypatch.setattr(gather, 'BUILD_DIR', tmp_path / '_build')


def test_missing_compiler_raises(monkeypatch, tmp_path):
    _fresh_build(monkeypatch, tmp_path)
    monkeypatch.setattr(gather, 'CXX', str(tmp_path / 'no-such-g++'))
    with pytest.raises(RuntimeError, match='no-such-g\\+\\+'):
        gather.gather_multi(_arrays(8), np.arange(4))
    assert gather.loaded() is None


def test_failed_build_raises_with_the_compiler_output(monkeypatch, tmp_path):
    _fresh_build(monkeypatch, tmp_path)
    broken = tmp_path / 'gather.cpp'
    broken.write_text('extern "C" void gather_multi_rows( {\n')
    monkeypatch.setattr(gather, 'SOURCE', broken)
    with pytest.raises(RuntimeError) as e:
        gather.gather_multi(_arrays(8), np.arange(4))
    text = str(e.value)
    assert 'g++' in text and 'batch gather' in text and 'error' in text
    assert not list((tmp_path / '_build').glob('*.so'))


def test_build_is_keyed_and_reused(monkeypatch, tmp_path):
    """A second build of the same source and flags reuses the library; a
    changed source builds another."""
    _fresh_build(monkeypatch, tmp_path)
    first = gather.build()
    assert first.parent == tmp_path / '_build' and first.exists()
    assert gather.build() == first
    src = tmp_path / 'gather.cpp'
    src.write_text(gather.SOURCE.read_text() + '\n// another\n')
    monkeypatch.setattr(gather, 'SOURCE', src)
    second = gather.build()
    assert second != first and second.exists()


def _same_batch(got, want):
    (rays, pixels), (jrays, jpixels) = got, want
    for name in Rays._fields:
        np.testing.assert_array_equal(getattr(rays, name),
                                      np.asarray(getattr(jrays, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(pixels, np.asarray(jpixels))


@pytest.fixture(scope='module')
def scene(tmp_path_factory):
    return make_blender_scene(str(tmp_path_factory.mktemp('scene')),
                              n_frames=3, size=16)


@pytest.mark.parametrize('which', ['blender', 'multicam'])
def test_dataset_batches_equal_jax_sample_batch(scene, tmp_path, which):
    """The port's batches, through the native gather, equal the JAX
    datasets' sample_batch (through its own) for the same Generator, draw
    after draw."""
    if which == 'blender':
        ours, theirs = Blender(scene, 'train'), JBlender(scene, 'train')
    else:
        data = str(tmp_path / 'multi')
        convert_to_nerfdata(scene, data, 2)
        ours, theirs = Multicam(data, 'train'), JMulticam(data, 'train')
    fields = [*ours.rays, ours.images]
    # Every field in the one pass, Blender's float64 directions and view
    # directions too.
    assert all(map(gather.native_ok, fields))
    rng, jrng = np.random.default_rng(7), np.random.default_rng(7)
    for batch in (32, 1, 300):
        _same_batch(ours.sample_batch(rng, batch),
                    theirs.sample_batch(jrng, batch))
    assert gather.loaded() is not None
    idx = np.array([0, ours.num_rays - 1, 0])
    rays, pixels = ours.gather(idx)
    np.testing.assert_array_equal(pixels, ours.images[idx])
    np.testing.assert_array_equal(rays.lossmult, ours.rays.lossmult[idx])
