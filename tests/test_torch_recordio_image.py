"""Port parity: RecordIO files, the image codecs, every ``npx.image`` op
and every vision transform against the JAX package.

- A ``.rec`` / ``.idx`` pair written by either package reads in the other
  (the bytes are the same), torn and bad-magic records raise the
  structured ``RecordIOCorrupt``, ``IRHeader`` scalar and vector labels.
- ``imencode`` / ``imdecode`` through the raw ``.npy`` codec and through
  PIL (PNG, lossless): the same bytes and pixels in both packages.
- ``npx.image``: the deterministic ops exactly (uint8) or at 1e-5 (float
  resamples, whose two contractions may round in another order; a uint8
  pixel may then round to the other side of .5, so uint8 resamples are
  held within 1, :data:`U8`); the
  random ops with the draw pinned (a degenerate range, p of 0 or 1) held
  against the JAX op, and by the law of the draw otherwise (flip rate,
  factor range), since torch's streams cannot give JAX's bits.
- The transforms through ``npx.image`` on the same inputs.
"""
import os

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import recordio as jrec
from mxnet_tpu.gluon.data import vision as jv
from mxnet_tpu.gluon.data.vision import transforms as jT

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import recordio as trec
from mxnet_tpu_torch.gluon.data import vision as tv
from mxnet_tpu_torch.gluon.data.vision import transforms as tT

torch.set_num_threads(2)

ATOL = 1e-5  # float resamples: two contractions in another order
U8 = 1       # uint8 resamples: a sum may round to the other side of .5


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def _img(n=None, h=9, w=11, seed=0):
    rs = onp.random.RandomState(seed)
    shape = (h, w, 3) if n is None else (n, h, w, 3)
    return rs.randint(0, 256, shape).astype("uint8")


def _close(got, want, atol=0.0):
    got = got.asnumpy() if hasattr(got, "asnumpy") else onp.asarray(got)
    want = want.asnumpy() if hasattr(want, "asnumpy") else onp.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    if atol:
        onp.testing.assert_allclose(got, want, rtol=0, atol=atol)
    else:
        onp.testing.assert_array_equal(got, want)


# -- RecordIO ------------------------------------------------------------------

def _write(mod, d, tag):
    rec, idx = os.path.join(d, f"{tag}.rec"), os.path.join(d, f"{tag}.idx")
    w = mod.MXIndexedRecordIO(idx, rec, "w")
    rs = onp.random.RandomState(1)
    for i in range(7):
        label = float(i) if i % 2 else [i, i + 0.5, 2.0]
        w.write_idx(i, mod.pack((0, label, i, 0),
                                rs.bytes(int(rs.randint(0, 13)))))
    w.close()
    return rec, idx


def test_rec_files_cross_between_packages(tmp_path):
    jr, ji = _write(jrec, str(tmp_path), "j")
    tr, ti = _write(trec, str(tmp_path), "t")
    assert open(jr, "rb").read() == open(tr, "rb").read()
    assert open(ji).read() == open(ti).read()
    for mod, (rec, idx) in ((trec, (jr, ji)), (jrec, (tr, ti))):
        r = mod.MXIndexedRecordIO(idx, rec, "r")
        other = (jrec if mod is trec else trec).MXIndexedRecordIO(idx, rec,
                                                                  "r")
        for k in reversed(r.keys):
            h1, p1 = mod.unpack(r.read_idx(k))
            h2, p2 = mod.unpack(other.read_idx(k))
            assert p1 == p2 and h1.id == h2.id == k
            onp.testing.assert_array_equal(onp.asarray(h1.label),
                                           onp.asarray(h2.label))
        seq = mod.MXRecordIO(rec, "r")
        n = 0
        while seq.read() is not None:
            n += 1
        assert n == 7


@pytest.mark.parametrize("cut,kind", [(-3, "torn_tail"), (4, "torn_tail")])
def test_torn_record_is_structured(tmp_path, cut, kind):
    rec, _ = _write(trec, str(tmp_path), "t")
    blob = open(rec, "rb").read()
    with open(rec, "wb") as f:
        f.write(blob[:cut] if cut < 0 else blob[:cut])
    r = trec.MXRecordIO(rec, "r")
    with pytest.raises(trec.RecordIOCorrupt) as ei:
        while r.read() is not None:
            pass
    assert ei.value.kind == kind and ei.value.resumable


def test_bad_magic_is_structured(tmp_path):
    rec, _ = _write(trec, str(tmp_path), "t")
    blob = bytearray(open(rec, "rb").read())
    blob[0] ^= 0xFF
    open(rec, "wb").write(bytes(blob))
    with pytest.raises(trec.RecordIOCorrupt) as ei:
        trec.MXRecordIO(rec, "r").read()
    assert ei.value.kind == "bad_magic" and not ei.value.resumable


# -- codecs ----------------------------------------------------------------------

@pytest.mark.parametrize("fmt", [".npy", ".png"])
def test_codecs_match_jax(fmt):
    img = _img()
    jb, tb = mx.image.imencode(img, fmt), tmx.image.imencode(img, fmt)
    assert jb == tb
    _close(tmx.image.imdecode(tb), mx.image.imdecode(jb))
    _close(tmx.image.imdecode(tb), img)
    if fmt == ".png":  # the raw codec keeps the stored channels
        gray = tmx.image.imdecode(tb, flag=0)
        assert gray.shape == (9, 11, 1)
        _close(gray, mx.image.imdecode(jb, flag=0))
    assert tmx.image.imdecode(tb)._data.device.type == "cpu"


def test_pack_img_and_record_datasets_match_jax(tmp_path):
    imgs = _img(6, seed=4)
    for mod, tag in ((jrec, "j"), (trec, "t")):
        w = mod.MXIndexedRecordIO(str(tmp_path / f"{tag}.idx"),
                                  str(tmp_path / f"{tag}.rec"), "w")
        for i, im in enumerate(imgs):
            w.write_idx(i, mod.pack_img((0, float(i % 3), i, 0), im,
                                        img_fmt=".npy"))
        w.close()
    assert (tmp_path / "j.rec").read_bytes() == (tmp_path / "t.rec") \
        .read_bytes()
    h, im = trec.unpack_img((tmp_path / "t.rec").read_bytes()[8:])
    onp.testing.assert_array_equal(im, imgs[0])
    j = jv.ImageRecordDataset(str(tmp_path / "t.rec"))
    t = tv.ImageRecordDataset(str(tmp_path / "j.rec"))
    from mxnet_tpu.gluon.data import RecordFileDataset as JR
    from mxnet_tpu_torch.gluon.data import RecordFileDataset as TR
    assert JR(str(tmp_path / "t.rec"))[2] == TR(str(tmp_path / "t.rec"))[2]
    assert len(j) == len(t) == 6
    for i in range(6):
        _close(t[i][0], j[i][0])
        _close(t[i][1], j[i][1])


def test_imread_npy_and_png(tmp_path):
    img = _img(seed=2)
    onp.save(tmp_path / "a.npy", img)
    (tmp_path / "a.png").write_bytes(tmx.image.imencode(img, ".png"))
    for name in ("a.npy", "a.png"):
        _close(tmx.image.imread(str(tmp_path / name)),
               mx.image.imread(str(tmp_path / name)))


# -- npx.image -------------------------------------------------------------------

def _both(fn, *args, atol=0.0, **kw):
    j = fn(mx.npx.image, *[mx.np.array(a) if isinstance(a, onp.ndarray)
                           else a for a in args], **kw)
    t = fn(tmx.npx.image, *[tmx.np.array(a) if isinstance(a, onp.ndarray)
                            else a for a in args], **kw)
    _close(t, j, atol)


@pytest.mark.parametrize("batched", [False, True])
def test_deterministic_ops_match_jax(batched):
    img = _img(3 if batched else None)
    imf = img.astype("float32") / 7
    _both(lambda m, x: m.to_tensor(x), img, atol=1e-7)
    chw = (img.astype("float32") / 255).transpose(
        (0, 3, 1, 2) if batched else (2, 0, 1))
    _both(lambda m, x: m.normalize(x, (0.4, 0.5, 0.6), (0.2, 0.3, 0.25)),
          chw, atol=1e-6)
    for size, keep in ((5, False), ((7, 4), False), (6, True)):
        for interp in (0, 1):
            _both(lambda m, x: m.resize(x, size, keep, interp), img,
                  atol=U8)
            _both(lambda m, x: m.resize(x, size, keep, interp), imf,
                  atol=ATOL)
    _both(lambda m, x: m.crop(x, 2, 1, 5, 4), img)
    _both(lambda m, x: m.flip_left_right(x), img)
    _both(lambda m, x: m.flip_top_bottom(x), img)
    _both(lambda m, x: m.adjust_lighting(x, (0.1, -0.2, 0.05)), img)
    _both(lambda m, x: m.adjust_lighting(x, (0.1, -0.2, 0.05)), imf,
          atol=ATOL)


@pytest.mark.parametrize("batched", [False, True])
def test_random_ops_with_pinned_draws_match_jax(batched):
    img = _img(4 if batched else None, seed=5)
    imf = img.astype("float32")
    # a fixed fractional position: CenterCrop's call, and an upsample
    for w, h in ((5, 4), (14, 12)):
        _both(lambda m, x: m.random_crop(x, (0.5, 0.5), (0.5, 0.5), w, h),
              img, atol=U8)
        _both(lambda m, x: m.random_crop(x, (0.0, 0.0), (1.0, 1.0), w, h,
                                         interp=0), img)
    # area 1 and aspect 1 of a square image: the whole image, resized
    sq = _img(4 if batched else None, h=10, w=10, seed=6)
    _both(lambda m, x: m.random_resized_crop(x, 6, 6, (1.0, 1.0),
                                             (1.0, 1.0)), sq, atol=U8)
    for p in (0.0, 1.0):
        _both(lambda m, x: m.random_flip_left_right(x, p), img)
        _both(lambda m, x: m.random_flip_top_bottom(x, p), img)
    for name in ("random_brightness", "random_contrast",
                 "random_saturation", "random_hue"):
        _both(lambda m, x: getattr(m, name)(x, 1.3, 1.3), img)
        _both(lambda m, x: getattr(m, name)(x, 0.7, 0.7), imf, atol=1e-3)
    _both(lambda m, x: m.random_color_jitter(x, 0, 0, 0, 0), img)
    _both(lambda m, x: m.random_lighting(x, 0.0), img)


def test_random_ops_follow_the_law_of_the_draw():
    img = _img(400, h=4, w=5, seed=7)
    gen = tmx.random.generator(3)
    out = tmx.npx.image.random_flip_left_right(img, generator=gen).asnumpy()
    flipped = (out == img[:, :, ::-1]).all(axis=(1, 2, 3)) & \
        ~(out == img).all(axis=(1, 2, 3))
    assert 0.4 < flipped.mean() < 0.6
    x = onp.full((400, 2, 2, 3), 100.0, "float32")
    b = tmx.npx.image.random_brightness(x, 0.5, 1.5, generator=gen) \
        .asnumpy()[:, 0, 0, 0] / 100.0
    assert b.min() >= 0.5 and b.max() <= 1.5 and abs(b.mean() - 1) < 0.05
    a = tmx.npx.image.random_lighting(x, 0.1, generator=gen).asnumpy()
    assert abs(a.mean() - 100.0) < 1.0 and a.std() > 0
    # the same generator state gives the same crops
    g1, g2 = tmx.random.generator(9), tmx.random.generator(9)
    c1 = tmx.npx.image.random_resized_crop(img, 3, 3, generator=g1)
    c2 = tmx.npx.image.random_resized_crop(img, 3, 3, generator=g2)
    _close(c1, c2)
    h = tmx.npx.image.random_hue(x, 0.5, 1.5, generator=gen).asnumpy()
    onp.testing.assert_allclose(h.sum(-1), 300.0, rtol=1e-5)  # gray stays


def test_random_draws_come_from_the_default_generator():
    img = _img(8, seed=1)
    tmx.random.seed(42)
    a = tmx.npx.image.random_color_jitter(img, 0.4, 0.4, 0.4, 0.1)
    tmx.random.seed(42)
    b = tmx.npx.image.random_color_jitter(img, 0.4, 0.4, 0.4, 0.1)
    _close(a, b)


# -- transforms ------------------------------------------------------------------

def _tboth(make, x, atol=0.0):
    j = make(jT)(mx.np.array(x))
    t = make(tT)(tmx.np.array(x))
    _close(t, j, atol)


@pytest.mark.parametrize("batched", [False, True])
def test_transforms_match_jax(batched):
    img = _img(3 if batched else None, h=12, w=10, seed=8)
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    _tboth(lambda T: T.Compose([T.ToTensor(), T.Normalize(mean, std)]),
           img, atol=1e-5)
    _tboth(lambda T: T.Cast("float16"), img)
    _tboth(lambda T: T.Resize((6, 5)), img, atol=U8)
    _tboth(lambda T: T.Resize(8, keep_ratio=True), img, atol=U8)
    _tboth(lambda T: T.CenterCrop(6), img, atol=U8)
    _tboth(lambda T: T.CenterCrop((14, 16)), img, atol=U8)
    _tboth(lambda T: T.CropResize(1, 2, 6, 5), img)
    _tboth(lambda T: T.CropResize(1, 2, 6, 5, size=4), img, atol=U8)
    for cls in ("RandomBrightness", "RandomContrast", "RandomSaturation",
                "RandomHue"):
        _tboth(lambda T: getattr(T, cls)(0.0), img)
    _tboth(lambda T: T.RandomColorJitter(), img)
    _tboth(lambda T: T.RandomLighting(0.0), img)
    # area 1 and aspect 1 of a square image: the whole image, resized
    _tboth(lambda T: T.RandomResizedCrop(5, scale=(1.0, 1.0),
                                         ratio=(1.0, 1.0)),
           img[:, :10] if batched else img[:10], atol=U8)
    for p in (0.0, 1.0):
        _tboth(lambda T: T.RandomGray(p), img, atol=1e-4)
    chw = (img.astype("float32") / 255).transpose(
        (0, 3, 1, 2) if batched else (2, 0, 1))
    for zin, zout in ((False, False), (True, False), (False, True)):
        _tboth(lambda T: T.Rotate(30.0, zin, zout), chw, atol=1e-5)


def test_host_coin_transforms_match_jax():
    img = _img(h=8, w=8, seed=9)
    onp.random.seed(3)
    j = [jT.RandomApply(jT.Cast("float16"), 0.5)(mx.np.array(img))
         for _ in range(6)]
    onp.random.seed(3)
    t = [tT.RandomApply(tT.Cast("float16"), 0.5)(tmx.np.array(img))
         for _ in range(6)]
    for a, b in zip(t, j):
        _close(a, b)
    chw = (img.astype("float32") / 255).transpose(2, 0, 1)
    onp.random.seed(4)
    j = jT.RandomRotation((-40, 40))(mx.np.array(chw))
    onp.random.seed(4)
    t = tT.RandomRotation((-40, 40))(tmx.np.array(chw))
    _close(t, j, 1e-5)
    with pytest.raises(ValueError, match="ordered"):
        tT.RandomRotation((5, 5))


def test_random_crop_and_flip_transforms_keep_pixels():
    """RandomCrop (padded) and the random flips move pixels without
    changing them: every output is a window / flip of its input."""
    img = _img(h=6, w=6, seed=10)
    out = tT.RandomCrop(6, pad=2)(tmx.np.array(img)).asnumpy()
    padded = onp.pad(img, ((2, 2), (2, 2), (0, 0)))
    assert any((padded[y:y + 6, x:x + 6] == out).all()
               for y in range(5) for x in range(5))
    for cls, flip in ((tT.RandomFlipLeftRight, img[:, ::-1]),
                      (tT.RandomFlipTopBottom, img[::-1])):
        o = cls()(tmx.np.array(img)).asnumpy()
        assert (o == img).all() or (o == flip).all()
    coin = tT.HybridRandomApply(tT.Cast("float16"), 1.0)
    _close(coin(tmx.np.array(img)), img.astype("float16"))
    with pytest.raises(ValueError, match="HybridCompose"):
        tT.HybridCompose([tT.RandomApply(tT.Cast(), 0.5)])
