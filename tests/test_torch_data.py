"""The port's copies of the host data modules against the JAX package's.

``mde_tpu_torch.data`` copies ``synthetic``, ``dataset``, ``native`` and
``loader`` so that the port imports nothing of ``mde_tpu``. These tests hold
each copy to its original on the same files: the same arrays, list files,
splits and batches, exactly (the data is uint8 and float32 read from disk, so
there is no tolerance). The port's synthetic PNGs are written with zlib
rather than PIL; they decode to the arrays the JAX generator writes, through
PIL and through the port's own PNG reader.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from mde_tpu.data import dataset as jax_dataset
from mde_tpu.data import loader as jax_loader
from mde_tpu.data import synthetic as jax_synthetic
from mde_tpu_torch.data import dataset, loader, native, synthetic

SIZE = (30, 40)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("data")
    out = {}
    for name, gen in (("jax", jax_synthetic), ("port", synthetic)):
        out[name] = str(base / name)
        gen.generate(out[name], n_train=7, n_test=3, size=SIZE, seed=4)
    return out


def _pngs(root):
    return sorted(os.path.join(root, d, f) for d in ("train", "test")
                  for f in os.listdir(os.path.join(root, d)) if f.endswith(".png"))


def test_generators_write_the_same_arrays_and_lists(roots):
    for list_name in ("train_list.txt", "test_list.txt"):
        with open(os.path.join(roots["jax"], list_name)) as a, \
                open(os.path.join(roots["port"], list_name)) as b:
            assert a.read() == b.read()
    jpngs, ppngs = _pngs(roots["jax"]), _pngs(roots["port"])
    assert [os.path.relpath(p, roots["jax"]) for p in jpngs] == \
        [os.path.relpath(p, roots["port"]) for p in ppngs]
    for jp, pp in zip(jpngs, ppngs):
        want = np.asarray(Image.open(jp).convert("RGB"))
        np.testing.assert_array_equal(np.asarray(Image.open(pp).convert("RGB")), want)
        np.testing.assert_array_equal(dataset.read_png(pp), want)
    for f in sorted(os.listdir(os.path.join(roots["jax"], "train"))):
        if f.endswith(".npy"):
            np.testing.assert_array_equal(np.load(os.path.join(roots["port"], "train", f)),
                                          np.load(os.path.join(roots["jax"], "train", f)))


def test_read_png_decodes_every_filter_type(roots, tmp_path):
    """PIL's encoder picks a filter a scanline (Sub, Up, Average, Paeth);
    its PNGs, RGBA and greyscale included, decode to PIL's own arrays."""
    rgb = np.asarray(Image.open(_pngs(roots["jax"])[0]).convert("RGB"))
    for mode in ("RGB", "RGBA", "L"):
        path = str(tmp_path / f"{mode}.png")
        Image.fromarray(rgb).convert(mode).save(path)
        want = np.asarray(Image.open(path).convert("RGB"))
        np.testing.assert_array_equal(dataset.read_png(path), want, err_msg=mode)


def test_write_png_rejects_what_it_cannot_write(tmp_path):
    with pytest.raises(ValueError, match="uint8"):
        synthetic.write_png(str(tmp_path / "x.png"), np.zeros((4, 4, 3), np.float32))


def test_dataset_and_split_match_the_original(roots):
    root = roots["jax"]
    a = jax_dataset.DepthDataset(os.path.join(root, "train"), os.path.join(root, "train_list.txt"))
    b = dataset.DepthDataset(os.path.join(root, "train"), os.path.join(root, "train_list.txt"))
    assert a.entries == b.entries and len(a) == len(b) == 7
    for i in range(len(a)):
        (ra, da, na), (rb, db, nb) = a.load(i), b.load(i)
        np.testing.assert_array_equal(ra, rb)
        np.testing.assert_array_equal(da, db)
        assert na == nb and a.paths(i) == b.paths(i)
    for n, frac, seed in ((7, 0.15, 0), (100, 0.15, 3), (20, 0.3, 1)):
        for x, y in zip(jax_dataset.split_train_val(n, frac, seed),
                        dataset.split_train_val(n, frac, seed)):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("use_native", [False, True])
def test_loader_yields_the_original_batches(roots, use_native, monkeypatch):
    """Shuffled, drop_last, several workers: the same batches in the same
    order; with a device the port yields the same values as tensors. The
    port's loader picks the native decoder when its library is there; the
    per-sample case hides the library."""
    if use_native and not native.available():
        pytest.skip("native/libdepthio.so is not built (make -C native)")
    if not use_native:
        monkeypatch.setattr(native, "available", lambda: False)
    root = roots["port"]
    ds_args = (os.path.join(root, "train"), os.path.join(root, "train_list.txt"))
    kw = dict(batch_size=3, shuffle=True, drop_last=True, num_workers=3, seed=5)
    want = list(jax_loader.HostLoader(jax_dataset.DepthDataset(*ds_args), use_native=use_native,
                                      **kw))
    got = list(loader.HostLoader(dataset.DepthDataset(*ds_args), **kw))
    on_cpu = list(loader.HostLoader(dataset.DepthDataset(*ds_args), device="cpu", **kw))
    assert len(want) == len(got) == len(on_cpu) == 2
    for w, g, c in zip(want, got, on_cpu):
        assert w["names"] == g["names"] == c["names"]
        for key in ("rgb", "depth"):
            np.testing.assert_array_equal(g[key], w[key])
            assert isinstance(c[key], torch.Tensor)
            np.testing.assert_array_equal(c[key].numpy(), w[key])


def test_native_binding_loads_the_shared_library():
    assert os.path.realpath(native._LIB_PATH) == os.path.realpath(
        os.path.join(os.path.dirname(jax_loader.__file__), "..", "..", "native", "libdepthio.so"))
