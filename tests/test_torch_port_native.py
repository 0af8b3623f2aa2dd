"""The port's native host pipeline (``fastvim_tpu_torch.native``) against
the JAX package's (``fastvim_tpu.native``) and against its own plain numpy
versions, on the CPU; then the loaders that use it against the JAX
loaders, with both natives on and with both off.

Inputs are seeded numpy arrays; the JPEGs are written by PIL into
``tmp_path``. Both packages compile the same C++ sources with the same
g++ flags, so their outputs are expected bit for bit. Against the plain
versions: the resize agrees within ``plain.resize_tol`` (under
``-march=native`` g++ may fuse a multiply and an add, numpy does not,
which moves a sample coordinate by up to one float32 ulp of the source's
larger side: 2.7e-4 at 500 px, 1.4e-4 at 200, in normalized units); the
cell augment only copies, subtracts and divides, so exactly; the decode
differs by what libjpeg's DCT scaling changes (it decodes a num/8 version
of the image whose pixel centres move by up to one scaled pixel), so a
mean per image within 0.1 in normalized units (about 6 of 255 grey
levels), and within 0.01 where the crop needs no scaling.
"""

import io
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
from PIL import Image

import fastvim_tpu.native as jnative
from fastvim_tpu.data import cells as jcells
from fastvim_tpu.data import loader as jloader
from fastvim_tpu_torch import native
from fastvim_tpu_torch.data import cells as pcells
from fastvim_tpu_torch.data import loader as ploader
from fastvim_tpu_torch.native import _build, plain

MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DECODE_MEAN_TOL = 0.1
UNSCALED_MEAN_TOL = 0.01


@pytest.fixture(scope="module", autouse=True)
def both_libraries():
    """Both packages' libraries, built here (g++ and libjpeg-turbo are
    this machine's); a missing one fails the module."""
    assert jnative.available(), "the JAX package's native library"
    assert native.available("augment") and native.available("decode")


def smooth_image(h, w, seed):
    """A photo-like RGB image: a few low-frequency waves per channel."""
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.full((h, w, 3), 128, np.float32)
    for c in range(3):
        for _ in range(2):
            fy, fx = r.uniform(0.5, 3) / h, r.uniform(0.5, 3) / w
            img[..., c] += 50 * np.sin(2 * np.pi * (fy * yy + fx * xx)
                                       + r.uniform(0, 2 * np.pi))
    return np.clip(img, 0, 255).astype(np.uint8)


def encode(arr, fmt="JPEG", mode=None, **kw):
    img = Image.fromarray(arr)
    if mode:
        img = img.convert(mode)
    buf = io.BytesIO()
    img.save(buf, fmt, **kw)
    return buf.getvalue()


def corrupted(data: bytes) -> bytes:
    """A JPEG with 40 bytes of its entropy-coded data flipped: libjpeg
    and PIL both decode it, with garbage in part of the image."""
    b = bytearray(data)
    for k in range(len(b) // 2, len(b) // 2 + 40):
        b[k] ^= 0x5A
    return bytes(b)


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_augment_batch_matches_jax_and_plain(training):
    """Three shapes (wider, taller, larger than the output): bitwise the
    JAX package's; within ``resize_tol`` of the plain version, whose crops
    and flips are the library's (a wrong rectangle would miss by whole
    pixels)."""
    rng = np.random.default_rng(0)
    before = native.call_counts()["augment_batch"]
    for i, (h, w) in enumerate(((48, 64), (91, 37), (150, 200))):
        imgs = rng.integers(0, 256, (6, h, w, 3), np.uint8)
        kw = dict(size=32, seed=1000 + i, training=training, mean=MEAN,
                  std=STD, scale=(0.2, 1.0))
        got = native.augment_batch(imgs, **kw)
        assert got.shape == (6, 32, 32, 3) and got.dtype == np.float32
        np.testing.assert_array_equal(got, jnative.augment_batch(imgs, **kw))
        np.testing.assert_allclose(got, plain.augment_batch(imgs, **kw),
                                   rtol=0, atol=plain.resize_tol(h, w, STD))
    assert native.call_counts()["augment_batch"] == before + 3


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("normalize", [True, False],
                         ids=["normalized", "raw"])
def test_cell_augment_batch_matches_jax_and_plain(training, normalize):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((5, 32, 32, 8)).astype(np.float32)
    norm = (dict(mean=rng.standard_normal(8).astype(np.float32),
                 std=(rng.random(8) + 0.5).astype(np.float32))
            if normalize else {})
    got = native.cell_augment_batch(x, 77, training, **norm)
    np.testing.assert_array_equal(
        got, jnative.cell_augment_batch(x, 77, training, **norm))
    np.testing.assert_array_equal(
        got, plain.cell_augment_batch(x, 77, training, **norm))
    if not training and not normalize:
        np.testing.assert_array_equal(got, x)


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_decode_augment_batch_matches_jax_and_plain(training, tmp_path):
    """JPEGs written by PIL (RGB at two qualities, greyscale, CMYK, one
    with flipped bytes), a PNG and a garbage stream: bitwise the JAX
    package's, images and fail flags; the flags the plain version's, and
    the images within the DCT-scaling tolerance."""
    streams = [encode(smooth_image(150, 200, i), quality=q)
               for i, q in enumerate((95, 80, 95))]
    streams.append(encode(smooth_image(120, 90, 3)[..., 0]))  # greyscale
    streams.append(encode(smooth_image(40, 50, 4), mode="CMYK"))
    streams.append(corrupted(encode(smooth_image(60, 80, 5))))
    streams.append(encode(smooth_image(30, 30, 6), "PNG"))
    streams.append(b"not a jpeg stream")
    for i, s in enumerate(streams):  # the same bytes through files
        (tmp_path / f"{i}.bin").write_bytes(s)
    streams = [(tmp_path / f"{i}.bin").read_bytes()
               for i in range(len(streams))]
    kw = dict(size=64, seed=4242, training=training, mean=MEAN, std=STD,
              scale=(0.2, 1.0))
    got, fail = native.decode_augment_batch(streams, **kw)
    want, want_fail = jnative.decode_augment_batch(streams, **kw)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(fail, want_fail)
    assert fail.tolist() == [0, 0, 0, 0, 1, 0, 1, 1]
    assert not got[fail == 1].any()  # a failed slot is zero-filled
    ref, ref_fail = plain.decode_augment_batch(streams, **kw)
    np.testing.assert_array_equal(fail, ref_fail)
    err = np.abs(got - ref).reshape(len(streams), -1).mean(axis=1)
    assert (err[:4] <= DECODE_MEAN_TOL).all(), err
    # upscaled crops decode at full size: only libjpeg's cropped decode
    # and its upsampling at the crop's edges differ from PIL's
    small = [encode(smooth_image(37, 91, 7)), encode(smooth_image(50, 40, 8))]
    got, _ = native.decode_augment_batch(small, **kw)
    ref, _ = plain.decode_augment_batch(small, **kw)
    err = np.abs(got - ref).reshape(2, -1).mean(axis=1)
    assert (err <= UNSCALED_MEAN_TOL).all(), err


def test_jpeg_dims_matches_jax_and_plain():
    streams = [encode(smooth_image(37, 91, 0)), encode(smooth_image(
        20, 10, 1), mode="CMYK"), encode(smooth_image(8, 9, 2), "PNG"),
        b"garbage", b""]
    want = [(37, 91), (20, 10), None, None, None]
    assert [native.jpeg_dims(s) for s in streams] == want
    assert [jnative.jpeg_dims(s) for s in streams] == want
    assert [plain.jpeg_dims(s) for s in streams] == want


def test_rng_and_crops_match_the_library():
    """The plain ``Rng`` and crop choice against the library over many
    seeds and shapes, at train (random resized crop, flip) and eval: each
    image holds its pixels' x and y indices in two channels, so a crop or
    a flip that differed would miss by whole pixels, far past
    ``resize_tol``."""
    rng = np.random.default_rng(3)
    for trial in range(60):
        h, w = (int(v) for v in rng.integers(8, 250, 2))
        yy, xx = np.mgrid[0:h, 0:w].astype(np.uint8)
        img = np.stack([xx, yy, xx // 2 + yy // 2], axis=-1)
        seed = int(rng.integers(0, 2**63 - 1))
        training = trial % 4 != 0
        got = native.augment_batch(img[None], 16, seed, training,
                                   np.zeros(3), np.ones(3))
        want = plain.augment_batch(img[None], 16, seed, training,
                                   np.zeros(3), np.ones(3))
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=plain.resize_tol(h, w, np.ones(3)),
                                   err_msg=f"trial {trial}")


def _image_folder(root):
    """<root>/{train,val}/<class>/: RGB JPEGs of several sizes, a
    greyscale one, the flipped-bytes one, two streams libjpeg refuses
    under a .jpg name (CMYK, a PNG), and a .png."""
    for split in ("train", "val"):
        for c in range(2):
            d = root / split / f"class{c}"
            d.mkdir(parents=True)
            for i in range(5):
                h, w = 40 + 13 * i, 70 - 7 * i
                (d / f"img{i}.jpg").write_bytes(
                    encode(smooth_image(h, w, 10 * c + i)))
        d = root / split / "class0"
        (d / "grey.jpeg").write_bytes(encode(smooth_image(50, 60, 90)[..., 0]))
        (d / "flipped.jpg").write_bytes(corrupted(encode(smooth_image(
            60, 80, 91))))
        (d / "cmyk.jpg").write_bytes(encode(smooth_image(45, 45, 92),
                                            mode="CMYK"))
        (d / "png_named.jpg").write_bytes(encode(smooth_image(44, 52, 93),
                                                 "PNG"))
        (root / split / "class1" / "img5.jpg").write_bytes(
            encode(smooth_image(64, 64, 95), quality=70))
        (root / split / "class1" / "real.png").write_bytes(
            encode(smooth_image(48, 48, 94), "PNG"))
    return str(root)


@pytest.mark.parametrize("split", ["train", "val"])
def test_native_jpeg_loader_bitwise_over_two_epochs(split, tmp_path):
    """``create_imagenet_loader`` on an ImageFolder (the MAE train recipe,
    and eval) gives both packages a ``NativeJpegDataLoader``; two epochs
    of its batches (a batch holding the .png takes PIL whole, the refused
    streams PIL alone) are bitwise the JAX loader's, and a fresh loader
    set to epoch 1 gives the second again."""
    root = _image_folder(tmp_path)
    kw = dict(batch_size=4, img_size=32, training=split == "train",
              mae=True, num_workers=3, seed=5)
    ours = ploader.create_imagenet_loader(root, split, **kw)
    theirs = jloader.create_imagenet_loader(root, split, **kw)
    assert isinstance(ours, ploader.NativeJpegDataLoader)
    assert isinstance(theirs, jloader.NativeJpegDataLoader)
    assert len(ours) == len(theirs) == 4
    native.reset_call_counts()
    epochs = []
    for _ in range(2):
        got, want = list(ours), list(theirs)
        epochs.append(got)
        assert len(got) == len(want) == 4
        for a, b in zip(got, want):
            assert a["image"].dtype == np.float32
            np.testing.assert_array_equal(a["image"], b["image"])
            np.testing.assert_array_equal(a["label"], b["label"])
    # one batch in each epoch holds real.png and goes to PIL whole
    assert native.call_counts()["decode_augment_batch"] == 6
    resumed = ploader.create_imagenet_loader(root, split, **kw)
    resumed.epoch = 1
    for a, b in zip(resumed, epochs[1]):
        np.testing.assert_array_equal(a["image"], b["image"])


@pytest.mark.parametrize("use_native", [True, False],
                         ids=["native", "python"])
def test_mae_synthetic_loader_bitwise(use_native):
    """The MAE train recipe on synthetic data, two epochs: with
    ``use_native`` both packages run it in their augment library, without
    it both in PIL (``transforms.mae_transform``); bitwise either way."""
    kw = dict(batch_size=4, img_size=32, training=True, mae=True,
              num_workers=3, seed=3, synthetic_samples=10,
              use_native=use_native)
    ours = ploader.create_imagenet_loader(None, "train", **kw)
    theirs = jloader.create_imagenet_loader(None, "train", **kw)
    native.reset_call_counts()
    for _ in range(2):
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a["image"], b["image"])
            np.testing.assert_array_equal(a["label"], b["label"])
    assert native.call_counts()["augment_batch"] == (16 if use_native else 0)


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("stored", [32, 40], ids=["at_size", "larger"])
def test_cell_loader_native_bitwise_over_two_epochs(training, stored):
    """``CellLoader`` with both natives on: images stored at the loader's
    size go raw into the C++ batch augment, larger ones through the
    Python ``cell_augment`` first, as in the JAX package; two epochs
    bitwise the JAX loader's, and a fresh loader set to epoch 1 gives the
    second again."""
    kw = dict(batch_size=4, size=32, training=training, seed=3,
              mean=[0.1 * c for c in range(5)],
              std=[1.0 + 0.1 * c for c in range(5)])
    make = lambda mod: mod.CellLoader(mod.SyntheticCellDataset(
        10, stored, 5, 7), **kw)
    ours, theirs = make(pcells), make(jcells)
    native.reset_call_counts()
    epochs = []
    for _ in range(2):
        got, want = list(ours), list(theirs)
        epochs.append(got)
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            assert a["image"].dtype == np.float32
            np.testing.assert_array_equal(a["image"], b["image"])
            np.testing.assert_array_equal(a["label"], b["label"])
    assert native.call_counts()["cell_augment_batch"] == 4
    resumed = make(pcells)
    resumed.epoch = 1
    for a, b in zip(resumed, epochs[1]):
        np.testing.assert_array_equal(a["image"], b["image"])


def test_cell_loader_without_the_library_takes_python(monkeypatch):
    """With the port's ``available`` answering False the loader augments
    image by image in Python (coarse dropout included), bitwise the JAX
    loader with its library off, and never calls the C++ batch augment."""
    monkeypatch.setattr(native, "available", lambda library="augment": False)
    monkeypatch.setattr(jnative, "available", lambda: False)
    kw = dict(batch_size=4, size=32, training=True, seed=4)
    native.reset_call_counts()
    got = list(pcells.CellLoader(pcells.SyntheticCellDataset(8, 32, 3), **kw))
    want = list(jcells.CellLoader(jcells.SyntheticCellDataset(8, 32, 3), **kw))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a["image"], b["image"])
    assert native.call_counts()["cell_augment_batch"] == 0


def test_call_counts_lose_no_update_across_threads():
    """The loaders call the library from several threads: 16 threads of
    200 calls each, with the interpreter switching threads as often as
    it can, count 3200 calls. (CPython 3.12 switches only at calls and
    loop jumps, so an unlocked ``+=`` would hold here too; the counters'
    lock is for interpreters that switch anywhere.)"""
    img = np.zeros((1, 4, 4, 3), np.uint8)
    switch = sys.getswitchinterval()
    native.reset_call_counts()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [native.augment_batch(
            img, 2, 0, False, MEAN, STD, num_threads=1) for _ in range(200)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert native.call_counts()["augment_batch"] == 3200


def test_entry_points_check_the_channel_arrays():
    x = np.zeros((1, 8, 8, 3), np.float32)
    with pytest.raises(ValueError, match="mean has shape"):
        native.augment_batch(x.astype(np.uint8), 4, 0, True, MEAN[:2], STD)
    with pytest.raises(ValueError, match="std has shape"):
        native.cell_augment_batch(x, 0, True, MEAN, STD[:1])
    with pytest.raises(ValueError, match="together"):
        native.cell_augment_batch(x, 0, True, mean=MEAN)


def _fresh_state(monkeypatch, tmp_path, csrc=None):
    """The port's native module with nothing loaded, building into
    ``tmp_path`` (and from ``csrc`` if given)."""
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    if csrc is not None:
        monkeypatch.setattr(_build, "CSRC", csrc)


def test_failed_compile_raises_with_the_compiler_output(monkeypatch,
                                                        tmp_path):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "common.h").write_text("#pragma once\n")
    (src / "augment.cpp").write_text(
        '#include "common.h"\nint broken( { return 0; }\n')
    _fresh_state(monkeypatch, tmp_path, src)
    with pytest.raises(RuntimeError, match=r"(?s)building the augment "
                       r"library failed.*augment\.cpp.*error"):
        native.available("augment")
    with pytest.raises(RuntimeError, match="building the augment library"):
        _build.build("augment")
    assert not list((tmp_path / "build").glob("*.so"))
    assert not list((tmp_path / "build").glob("*.tmp"))


def test_missing_compiler_is_reported(monkeypatch, tmp_path, capsys):
    """No compiler: ``available`` answers False and says so on stderr,
    once; an entry point and ``build`` raise."""
    _fresh_state(monkeypatch, tmp_path)
    monkeypatch.setattr(_build, "CXX", str(tmp_path / "no-such-g++"))
    assert "no-such-g++" in _build.missing("augment")
    assert not native.available("augment")
    assert not native.available("augment")
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and "augment library is unavailable" in err[0]
    assert "no-such-g++" in err[0]
    with pytest.raises(RuntimeError, match="augment library is unavailable"):
        native.cell_augment_batch(np.zeros((1, 4, 4, 1), np.float32), 0,
                                  True)
    with pytest.raises(RuntimeError, match="cannot build the augment"):
        _build.build("augment")


def test_missing_jpeglib_is_reported(monkeypatch, tmp_path, capsys):
    """A jpeglib.h that is not libjpeg-turbo's (the probe's check made
    to fail): the decode library is unavailable and says why; the
    augment library is untouched."""
    _fresh_state(monkeypatch, tmp_path)
    monkeypatch.setattr(_build, "JPEG_PROBE",
                        "#include <no_such_jpeglib_here.h>\n")
    assert native.available("augment")
    assert not native.available("decode")
    err = capsys.readouterr().err
    assert "decode library is unavailable" in err
    assert "no libjpeg-turbo jpeglib.h" in err
    with pytest.raises(RuntimeError, match="decode library is unavailable"):
        native.jpeg_dims(encode(smooth_image(8, 8, 0)))


def test_library_names_and_concurrent_builds(tmp_path, monkeypatch):
    """Each library is named by a hash of its own sources and the flags;
    four processes building at once into an empty directory leave one
    library and no temporaries."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    a, d = _build.library_path("augment"), _build.library_path("decode")
    assert a.parent == d.parent == tmp_path and a != d
    assert a.name.startswith("libfastvim_native_augment_")
    monkeypatch.setattr(_build, "CXXFLAGS", [*_build.CXXFLAGS, "-g"])
    assert _build.library_path("augment") != a
    code = ("import sys; from fastvim_tpu_torch.native import _build; "
            "from pathlib import Path; _build.BUILD_DIR = Path(sys.argv[1]); "
            "print(_build.build('augment'))")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              stdout=subprocess.PIPE, text=True, cwd=ROOT)
             for _ in range(4)]
    outs = {p.communicate(timeout=120)[0].strip() for p in procs}
    assert all(p.returncode == 0 for p in procs)
    assert outs == {str(a)}
    assert sorted(f.suffix for f in tmp_path.iterdir()) == [".lock", ".so"]


def test_import_builds_nothing_and_imports_no_pil():
    code = ("import sys\nimport fastvim_tpu_torch.native as n\n"
            "import fastvim_tpu_torch.native.plain\n"
            "assert n._libs == {}, n._libs\n"
            "assert 'PIL' not in sys.modules\n"
            "assert not any(m.split('.')[0] in ('jax', 'fastvim_tpu')\n"
            "               for m in sys.modules)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=60, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
