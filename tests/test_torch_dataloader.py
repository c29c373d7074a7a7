"""The port's native data loader (runtime/dataloader.py on its own copy of
native/dataloader.cpp, built by g++ at first use) against the JAX
package's loader on the same archives, on the CPU: batch order, the short
tail batch, loop mode, and the sizes it must refuse.  Batches are compared
bit for bit.  No wall-clock assertion: a timing on a shared CPU box is not
steady enough to gate on."""

import numpy as np
import pytest

from csinn2_tpu.runtime.dataloader import DataLoader as JDataLoader
from csinn2_tpu_torch.runtime import bm
from csinn2_tpu_torch.runtime import dataloader as tdl
from csinn2_tpu_torch.runtime.dataloader import DataLoader, write_archive


@pytest.fixture
def archive(tmp_path, rng):
    data = rng.standard_normal((10, 4, 3)).astype(np.float32)
    path = str(tmp_path / "samples.f32")
    write_archive(path, data)
    return path, data


def test_batches_roundtrip(archive):
    path, data = archive
    with DataLoader(path, sample_shape=(4, 3), batch=4) as dl:
        assert dl.n_samples == 10
        batches = list(dl)
    assert [b.shape[0] for b in batches] == [4, 4, 2]   # tail batch short
    assert all(b.dtype == np.float32 for b in batches)
    np.testing.assert_array_equal(np.concatenate(batches), data)
    with JDataLoader(path, sample_shape=(4, 3), batch=4) as jdl:
        jbatches = list(jdl)
    assert len(jbatches) == len(batches)
    for a, b in zip(batches, jbatches):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("batch", [3, 8, 25])
def test_loop_mode_wraps(archive, batch):
    path, data = archive
    with DataLoader(path, sample_shape=(4, 3), batch=batch, loop=True) as dl:
        got = [dl.next() for _ in range(3)]
    with JDataLoader(path, sample_shape=(4, 3), batch=batch, loop=True) as jdl:
        jgot = [jdl.next() for _ in range(3)]
    assert all(b.shape == (batch, 4, 3) for b in got)
    seq = np.concatenate(got).reshape(3 * batch, -1)
    want = np.concatenate([data] * (3 * batch // 10 + 1)).reshape(-1, 12)[:3 * batch]
    np.testing.assert_array_equal(seq, want)
    np.testing.assert_array_equal(np.concatenate(got), np.concatenate(jgot))


def test_order_through_a_small_prefetch_queue(tmp_path, rng):
    """64 samples through a queue of depth 1 and 2: every batch in order."""
    data = rng.standard_normal((64, 16)).astype(np.float32)
    path = str(tmp_path / "big.f32")
    write_archive(path, data)
    for depth in (1, 2):
        with DataLoader(path, sample_shape=(16,), batch=8, prefetch_depth=depth) as dl:
            out = list(dl)
        assert len(out) == 8
        np.testing.assert_array_equal(np.concatenate(out), data)


def test_bad_sizes_rejected(tmp_path):
    path = str(tmp_path / "bad.f32")
    np.zeros(7, np.float32).tofile(path)    # not a multiple of the sample size
    with pytest.raises(OSError):
        DataLoader(path, sample_shape=(4, 3), batch=2)
    with pytest.raises(OSError):
        JDataLoader(path, sample_shape=(4, 3), batch=2)
    with pytest.raises(OSError):
        DataLoader(str(tmp_path / "missing.f32"), sample_shape=(4, 3), batch=2)
    with pytest.raises(ValueError, match="batch"):
        DataLoader(path, sample_shape=(7,), batch=0)


def test_closed_loader_raises(archive):
    path, _ = archive
    dl = DataLoader(path, sample_shape=(4, 3), batch=4)
    dl.close()
    dl.close()                               # twice is harmless
    with pytest.raises(ValueError, match="closed"):
        dl.next()


def test_build_into_the_port_build_dir():
    """The library comes from the port's own source, built into
    native/_build/ (never the JAX package's prebuilt .so)."""
    lib = tdl._load_lib()
    so = bm.build_native(tdl.SOURCE, bm.BUILD_DIR, tdl.CXX_FLAGS)
    assert so.parent == bm.BUILD_DIR and so.name.startswith("libdataloader-")
    assert tdl.SOURCE.parent.parent.name == "csinn2_tpu_torch"
    assert lib._name == str(so)


def test_failed_build_raises_with_the_compiler_output(tmp_path):
    src = tmp_path / "broken.cpp"
    src.write_text("int f( {\n")
    with pytest.raises(RuntimeError, match="broken.cpp"):
        bm.build_native(src, tmp_path / "build", tdl.CXX_FLAGS)
    assert not any((tmp_path / "build").iterdir())
