"""The port's native FFmpeg decoder (jepa_tpu_torch.native) vs the JAX
package's (jepa_tpu.native) on the same files, on the CPU.

Frames, dataset items and the grating dataset's files must be byte-equal:
the two libraries compile the same C++ source. Skips where FFmpeg's
libraries or headers are missing (the library cannot be built), as
tests/test_native_decode.py does. JAX's side runs first in each test.
"""

import os

import numpy as np
import pytest

from jepa_tpu.data import synthetic as jax_synthetic
from jepa_tpu.data import video_dataset as jax_video_dataset
from jepa_tpu_torch.data import synthetic, video_dataset

N_FRAMES = 80


@pytest.fixture(scope="module")
def decoders():
    """(JAX videodec, port videodec); skips when either library cannot be built."""
    from jepa_tpu_torch.native import build, videodec

    try:
        build.build()
        jax_videodec = pytest.importorskip("jepa_tpu.native.videodec")
        jax_videodec._load()
    except (RuntimeError, OSError) as e:  # no g++, or no FFmpeg headers or libraries
        pytest.skip(f"the native decoder cannot be built here: {e}")
    return jax_videodec, videodec


@pytest.fixture(scope="module")
def videos(decoders, tmp_path_factory):
    """Test-pattern videos: two 192x128 (3:2) and a portrait 96x160, written
    by the port's encoder."""
    _, videodec = decoders
    d = tmp_path_factory.mktemp("native_videos")
    paths = []
    for i, (w, h) in enumerate(((192, 128), (192, 128), (96, 160))):
        p = str(d / f"vid{i}.mp4")
        videodec.write_test_video(p, num_frames=N_FRAMES, width=w, height=h, seed=i)
        paths.append(p)
    return paths


def test_encoders_write_the_same_bytes(decoders, tmp_path):
    jax_videodec, videodec = decoders
    frames = np.random.default_rng(0).integers(0, 256, size=(9, 48, 64, 3), dtype=np.uint8)
    for name, mod in (("jax", jax_videodec), ("port", videodec)):
        mod.write_test_video(str(tmp_path / f"{name}_pattern.mp4"), num_frames=20, seed=2)
        mod.write_video(str(tmp_path / f"{name}_frames.mp4"), frames, fps=25.0)
    for kind in ("pattern", "frames"):
        assert ((tmp_path / f"jax_{kind}.mp4").read_bytes()
                == (tmp_path / f"port_{kind}.mp4").read_bytes())
    with pytest.raises(ValueError, match="T, H, W, 3"):
        videodec.write_video(str(tmp_path / "bad.mp4"), frames[..., 0])


@pytest.mark.parametrize("indices,out_size", [
    (list(range(N_FRAMES)), None),                 # sequential
    ([0, 7, 23, 24, 25, 60, 79], None),            # random access across keyframes
    ([60, 5, 30, 5, 79, 0], None),                 # out of order, duplicated
    ([78, 79, 200], None),                         # past the end: the last frame
    ([3, 40, 11], (64, 96)),                       # resized in sws_scale
    ([50, 2], (161, 97)),                          # odd output size
])
@pytest.mark.parametrize("which", [0, 2])
def test_reader_frames_equal_jax(decoders, videos, indices, out_size, which):
    jax_videodec, videodec = decoders
    jr = jax_videodec.VideoReader(videos[which], threads=2)
    want = jr.get_batch(indices, out_size=out_size)
    meta = (len(jr), jr.get_avg_fps(), jr.width, jr.height)
    jr.close()

    r = videodec.VideoReader(videos[which], threads=2)
    got = r.get_batch(indices, out_size=out_size)
    assert (len(r), r.get_avg_fps(), r.width, r.height) == meta
    r.close()
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if out_size is None and which == 0:  # decoded content follows the pattern
        t = indices[1]
        ys, xs = np.mgrid[5:20, 5:40]
        t_hat = np.median((got[1][ys, xs, 1].astype(np.float64) - ys) / 3.0)
        assert abs(t_hat - t) < 1.0


@pytest.mark.parametrize("short_side,canvas", [(96, (192, 192)), (64, None), (200, (180, 150))])
@pytest.mark.parametrize("which", [0, 2])
def test_decode_aspect_equals_jax(decoders, videos, short_side, canvas, which):
    jax_videodec, videodec = decoders
    idx = np.array([1, 9, 33, 70])
    jb = jax_videodec.NativeBackend(short_side=short_side, canvas=canvas)
    want, want_hw = jb.decode_aspect(videos[which], idx)
    want_probe = jb.probe(videos[which])

    be = videodec.NativeBackend(short_side=short_side, canvas=canvas)
    got, got_hw = be.decode_aspect(videos[which], idx)
    assert be.probe(videos[which]) == want_probe
    assert tuple(got_hw) == tuple(want_hw)
    np.testing.assert_array_equal(got, want)
    hp, wp = got_hw
    assert got[:, hp:].sum() == 0 and got[:, :, wp:].sum() == 0
    assert got[:, :hp, :wp].std() > 10


def _items(ds, n):
    ds.set_epoch(1)
    return [ds[i] for i in range(n)]


@pytest.mark.parametrize("geom", [dict(decode_size=(64, 80)),
                                  dict(decode_short_side=72, decode_canvas=(144, 144)),
                                  dict()])
def test_video_dataset_items_equal_jax(decoders, videos, tmp_path, geom):
    manifest = tmp_path / "m.csv"
    manifest.write_text("".join(f"{p} {i + 3}\n" for i, p in enumerate(videos)))
    kw = dict(data_paths=[str(manifest)], frames_per_clip=8, frame_step=3, num_clips=2,
              decode_backend="native", seed=4, **geom)
    want = _items(jax_video_dataset.VideoDataset(**kw), len(videos))
    got = _items(video_dataset.VideoDataset(**kw), len(videos))
    for (gc, gl, gi, gv), (wc, wl, wi, wv) in zip(got, want):
        assert gc.dtype == np.uint8 and gc.shape == wc.shape
        np.testing.assert_array_equal(gc, wc)
        assert gl == wl
        for a, b in zip(gi, wi):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(gv, wv)


def test_grating_dataset_equals_jax(decoders, tmp_path):
    jax_videodec, videodec = decoders
    kw = dict(n_train_per_class=2, n_val_per_class=1, num_frames=6, size=32, seed=3)
    want = jax_synthetic.write_grating_dataset(str(tmp_path / "jax"), **kw)
    want_gabor = jax_synthetic.write_grating_dataset(str(tmp_path / "jax_gabor"), kind="gabor",
                                                     **kw)
    got = synthetic.write_grating_dataset(str(tmp_path / "port"), **kw)
    got_gabor = synthetic.write_grating_dataset(str(tmp_path / "port_gabor"), kind="gabor", **kw)
    for port_csvs, jax_csvs in ((got, want), (got_gabor, want_gabor)):
        for g, w in zip(port_csvs, jax_csvs):
            g_rows = [ln.split() for ln in open(g).read().splitlines()]
            w_rows = [ln.split() for ln in open(w).read().splitlines()]
            assert [(os.path.basename(p), c) for p, c in g_rows] == \
                   [(os.path.basename(p), c) for p, c in w_rows]
            for (gp, _), (wp, _) in zip(g_rows, w_rows):
                want_frames = jax_videodec.VideoReader(wp).get_batch(range(6))
                got_frames = videodec.VideoReader(gp).get_batch(range(6))
                np.testing.assert_array_equal(got_frames, want_frames)
    assert len(open(got[0]).read().splitlines()) == 4


def test_native_and_auto_pick_native_backend(decoders):
    _, videodec = decoders
    for name in ("native", "auto"):
        be = video_dataset.get_backend(name, short_side=64, canvas=(128, 128))
        assert isinstance(be, videodec.NativeBackend) and be.canvas == (128, 128)
    assert video_dataset.get_backend("auto", (32, 48)).out_size == (32, 48)
