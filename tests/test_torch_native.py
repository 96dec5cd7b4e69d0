"""The port's binding of the native host library (saro_gs_torch/native.py)
against the JAX package's binding (saro_gs_tpu/native.py) and the port's
own Python paths, on the cases of tests/test_native.py.

Both bindings load code compiled from native/src with the same flags, so
their outputs are compared exactly; the Python paths (struct parsing, PIL,
the blockwise knn of ops/knn.py) with the tolerances of
tests/test_native.py.  The port builds two libraries: the core one (COLMAP
parsing, knn), which links no image library, and the image one (the
decoders); where the image library does not build, the COLMAP readers
stay native and the decode takes PIL.
"""
import os
import subprocess

import numpy as np
import pytest
import torch

from saro_gs_torch import native
from saro_gs_torch.data import cameras, colmap, dataset, pointcloud
from saro_gs_tpu import native as jnative

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def python_paths(monkeypatch):
    """SARO_NATIVE=0 inside the block: the callers' Python paths."""
    def switch():
        monkeypatch.setenv("SARO_NATIVE", "0")
    return switch


def test_builds_into_build_dir():
    native.build()
    assert native.available()
    assert native.SO_PATH == os.path.join(
        ROOT, "build", "saro_gs_torch", "native", "libsaro_native.so")
    assert os.path.exists(native.SO_PATH)
    assert native.lib().sn_version() == b"saro_native 0.1.0"


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    src = tmp_path / "src"
    src.mkdir()
    for f in native.SOURCES + native.HEADERS:
        (src / f).write_text("this is not C++;\n")
    monkeypatch.setattr(native, "SRC_DIR", str(src))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "out"))
    monkeypatch.setattr(native, "SO_PATH", str(tmp_path / "out" / "lib.so"))
    with pytest.raises(RuntimeError, match="error"):
        native.build()
    assert not os.path.exists(tmp_path / "out" / "lib.so")


def test_disabled_returns_none(monkeypatch):
    monkeypatch.setenv("SARO_NATIVE", "0")
    assert native.lib() is None and not native.available()
    assert native.nn_distance(np.zeros((4, 3), np.float32)) is None


def _write_colmap(tmp_path, rng):
    n = 50
    xyz = rng.randn(n, 3)
    rgb = rng.randint(0, 255, (n, 3)).astype(np.uint8)
    colmap.write_points3d_binary(xyz, rgb, tmp_path / "points3D.bin")
    cams = {1: colmap.ColmapCamera(1, "PINHOLE", 640, 480,
                                   np.array([500.0, 510.0, 320.0, 240.0])),
            2: colmap.ColmapCamera(2, "SIMPLE_PINHOLE", 320, 200,
                                   np.array([250.0, 160.0, 100.0]))}
    colmap.write_cameras_binary(cams, tmp_path / "cameras.bin")
    images = {}
    for i in range(1, 4):
        q = rng.randn(4)
        q /= np.linalg.norm(q)
        images[i] = colmap.ColmapImage(i, q, rng.randn(3), 1 + i % 2,
                                       f"cam{i:02d}.png", None, None)
    colmap.write_images_binary(images, tmp_path / "images.bin")


def test_colmap_binary_parity(tmp_path, rng, python_paths):
    _write_colmap(tmp_path, rng)
    p3d, cams_bin, imgs_bin = (str(tmp_path / f) for f in
                               ("points3D.bin", "cameras.bin", "images.bin"))
    # the binding against the JAX package's
    for mine, theirs in zip(native.read_points3d_bin(p3d),
                            jnative.read_points3d_bin(p3d)):
        assert mine.dtype == theirs.dtype
        np.testing.assert_array_equal(mine, theirs)
    for a, b in zip(native.read_cameras_bin(cams_bin),
                    jnative.read_cameras_bin(cams_bin)):
        assert a[:4] == b[:4]
        np.testing.assert_array_equal(a[4], b[4])
    for a, b in zip(native.read_images_bin(imgs_bin),
                    jnative.read_images_bin(imgs_bin)):
        assert (a[0], a[3], a[4]) == (b[0], b[3], b[4])
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[2], b[2])
    # the readers through the library, then through Python
    nat = (colmap.read_points3d_binary(p3d),
           colmap.read_cameras_binary(cams_bin),
           colmap.read_images_binary(imgs_bin))
    python_paths()
    py = (colmap.read_points3d_binary(p3d),
          colmap.read_cameras_binary(cams_bin),
          colmap.read_images_binary(imgs_bin))
    for a, b in zip(nat[0], py[0]):
        np.testing.assert_array_equal(a, b)
    assert nat[1].keys() == py[1].keys() == {1, 2}
    for cid in nat[1]:
        a, b = nat[1][cid], py[1][cid]
        assert (a.id, a.model, a.width, a.height) == (b.id, b.model,
                                                      b.width, b.height)
        np.testing.assert_array_equal(a.params, b.params)
    assert nat[2].keys() == py[2].keys()
    for iid in nat[2]:
        a, b = nat[2][iid], py[2][iid]
        assert (a.name, a.camera_id) == (b.name, b.camera_id)
        np.testing.assert_array_equal(a.qvec, b.qvec)
        np.testing.assert_array_equal(a.tvec, b.tvec)


def test_points3d_tracks_skipped(tmp_path, rng):
    """points3D.bin records with tracks (0 to 40 observations, one of 700
    so that a skip spans several reads of the core library's buffer) and
    per-point errors: the core library, the JAX binding and the Python
    loop read the same points."""
    import struct
    n = 300
    xyz, rgb, err = rng.randn(n, 3), rng.randint(0, 255, (n, 3)), rng.rand(n)
    tracks = rng.randint(0, 41, n)
    tracks[n // 2] = 700
    path = str(tmp_path / "points3D.bin")
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", n))
        for i in range(n):
            f.write(struct.pack("<QdddBBBd", i, *xyz[i], *rgb[i], err[i]))
            f.write(struct.pack("<Q", tracks[i]))
            f.write(rng.randint(0, 99, 2 * tracks[i]).astype("<i4")
                    .tobytes())
    mine = native.read_points3d_bin(path)
    for a, b, c in zip(mine, jnative.read_points3d_bin(path),
                       colmap.read_points3d_binary_py(path)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    np.testing.assert_array_equal(mine[0], xyz)
    np.testing.assert_array_equal(mine[1], rgb)
    np.testing.assert_array_equal(mine[2], err)
    # a track cut short: the core library refuses the file
    with open(path, "rb") as f:
        whole = f.read()
    with open(path, "wb") as f:
        f.write(whole[:-4])
    assert native.read_points3d_bin(path) is None


@pytest.mark.parametrize("layout", ["normal", "clustered"])
def test_nn_distance(layout, rng):
    """Exact against a k-d tree and the JAX binding; the point-cloud
    preprocessing's knn (ops/knn.py) within float32 of it."""
    from scipy.spatial import cKDTree
    if layout == "normal":
        pts = rng.randn(2000, 3).astype(np.float32)
        tol = dict(rtol=1e-5, atol=1e-6)
    else:
        # clusters and far outliers stress the expanding-ring search
        pts = np.concatenate([
            rng.randn(500, 3) * 0.01, rng.randn(500, 3) * 0.01 + 50.0,
            rng.randn(20, 3) * 300.0]).astype(np.float32)
        tol = dict(rtol=1e-4, atol=1e-5)
    d = native.nn_distance(pts)
    np.testing.assert_array_equal(d, jnative.nn_distance(pts))
    ref, _ = cKDTree(pts).query(pts, k=2)
    np.testing.assert_allclose(d, ref[:, 1], **tol)
    np.testing.assert_allclose(pointcloud._nn_distance(pts, "cpu"), d, **tol)


def test_mean_sq_dist_3nn_and_tiny_inputs(rng):
    pts = rng.randn(800, 3).astype(np.float32)
    out = native.knn_mean_sq_dist(pts, 3)
    np.testing.assert_array_equal(out, jnative.knn_mean_sq_dist(pts, 3))
    d2 = ((pts[:, None] - pts[None]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    ref = np.sort(d2, axis=1)[:, :3].mean(axis=1)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-6)
    assert native.nn_distance(np.zeros((1, 3), np.float32))[0] == 0.0
    np.testing.assert_allclose(native.knn_mean_sq_dist(
        np.array([[0, 0, 0], [1, 0, 0]], np.float32), 3), [1.0, 1.0])


def _png(tmp_path, rng, size=(64, 48), alpha=False, name=None):
    from PIL import Image
    c = 4 if alpha else 3
    arr = rng.randint(0, 255, (size[1], size[0], c)).astype(np.uint8)
    path = str(tmp_path / (name or f"img{c}.png"))
    Image.fromarray(arr, "RGBA" if alpha else "RGB").save(path)
    return path, arr


@pytest.mark.parametrize("case", ["same_size", "alpha", "resize", "jpeg"])
def test_image_decode(case, tmp_path, rng):
    """Each decode equals the JAX binding's, and sits within
    tests/test_native.py's tolerance of PIL (load_image_pil)."""
    from PIL import Image
    bg, w, h = (0.0, 0.0, 0.0), 64, 48
    if case == "same_size":
        path, arr = _png(tmp_path, rng)
        ref, tol = np.moveaxis(arr, -1, 0) / 255.0, 1e-6
    elif case == "alpha":
        path, arr = _png(tmp_path, rng, alpha=True)
        bg = (1.0, 1.0, 1.0)
        a = arr[..., 3:] / 255.0
        ref = np.moveaxis(arr[..., :3] / 255.0 * a + (1 - a), -1, 0)
        tol = 1e-6
    elif case == "resize":
        path, _ = _png(tmp_path, rng, size=(128, 96))
        w, h = 40, 30
        ref = np.moveaxis(np.asarray(Image.open(path).resize(
            (w, h), Image.LANCZOS)).astype(np.float32) / 255.0, -1, 0)
        tol = 0.008      # PIL keeps 8-bit intermediates
    else:
        g = np.linspace(0, 255, 64, dtype=np.uint8)
        path = str(tmp_path / "img.jpg")
        Image.fromarray(np.stack([np.tile(g, (48, 1))] * 3, -1),
                        "RGB").save(path, quality=95)
        ref = np.moveaxis(np.asarray(Image.open(path)).astype(np.float32)
                          / 255.0, -1, 0)
        tol = 0.02       # two JPEG decoders
    out = native.load_image(path, w, h, bg)
    assert out.shape == (3, h, w) and out.dtype == np.float32
    np.testing.assert_array_equal(out, jnative.load_image(path, w, h, bg))
    assert np.abs(out - ref).max() <= tol
    pil = cameras.load_image_pil(path, w, h, white_background=bg[0] == 1.0)
    assert np.abs(out - pil).max() <= max(tol, 1e-6)


def test_batch_decode_and_loader(tmp_path, rng, python_paths):
    """A batch decodes as its images one by one and as the JAX binding's
    batch; BatchLoader takes it in one call and gives the uint8 ground
    truth of the per-camera Python path within one step of rounding."""
    paths = [_png(tmp_path, rng, size=(32 + i, 24), name=f"b{i}.png")[0]
             for i in range(8)]
    out = native.load_images(paths, 16, 12)
    assert out.shape == (8, 3, 12, 16)
    np.testing.assert_array_equal(out, jnative.load_images(paths, 16, 12))
    for i, p in enumerate(paths):
        np.testing.assert_array_equal(out[i], native.load_image(p, 16, 12))

    same = [_png(tmp_path, rng, size=(16, 12), alpha=True,
                 name=f"s{i}.png")[0] for i in range(4)]
    cams = [cameras.Camera(uid=i, R=np.eye(3), T=np.array([0, 0, 4.0]),
                           fovx=1.0, fovy=0.8, width=16, height=12,
                           image_path=p) for i, p in enumerate(same)]
    loader = dataset.BatchLoader(cams, 4, white_background=True,
                                 shuffle=False, num_workers=1)
    try:
        nat = loader._load_batch(np.arange(4)).gt
        python_paths()
        py = loader._load_batch(np.arange(4)).gt
    finally:
        loader.close()
    assert nat.dtype == py.dtype == np.uint8
    assert np.abs(nat.astype(int) - py.astype(int)).max() <= 1


def test_camera_load_image_native_and_pil(tmp_path, rng, python_paths):
    path, _ = _png(tmp_path, rng, size=(64, 48), alpha=True)
    cam = cameras.Camera(uid=0, R=np.eye(3), T=np.zeros(3), fovx=1.0,
                         fovy=1.0, width=32, height=24, image_path=path)
    nat = cam.load_image(white_background=True)
    np.testing.assert_array_equal(
        nat, jnative.load_image(path, 32, 24, (1.0, 1.0, 1.0)))
    python_paths()
    pil = cam.load_image(white_background=True)
    assert nat.shape == pil.shape == (3, 24, 32)
    # PIL keeps 8-bit resize intermediates and premultiplies alpha: a few
    # steps of 1/255 on noise (tests/test_native.py's gate)
    d = np.abs(nat - pil)
    assert d.max() < 0.05 and d.mean() < 0.005


def test_device_knn_matches_native(rng):
    """The scene's nearest-neighbour distances (ops/knn.py on the tensor's
    device) against the native library's, on a denser cloud."""
    pts = (rng.rand(5000, 3) * 2.6 - 1.3).astype(np.float32)
    dev = pointcloud._nn_distance(pts, torch.device("cpu"))
    np.testing.assert_allclose(dev, native.nn_distance(pts), rtol=1e-5,
                               atol=1e-6)


def test_core_library_links_no_image_libraries():
    """The core library's g++ line names no -lpng, -ljpeg or -lz, the
    built library needs none of them at load time, and it binds the COLMAP
    and knn entry points and no decoder; the image library's line carries
    native/Makefile's libraries."""
    core = native.command(native.SO_PATH, native.core_sources(),
                          native.CORE_LDLIBS)
    assert not {"-lpng", "-ljpeg", "-lz"} & set(core)
    assert [os.path.basename(f) for f in native.core_sources()] == [
        "knn.cpp", "native_core.cpp"]
    image = native.command(native.IMAGE_SO_PATH, native.image_sources(),
                           native.LDLIBS)
    assert {"-lpng", "-ljpeg", "-lz"} <= set(image)
    assert [os.path.basename(f) for f in native.image_sources()] == [
        "image.cpp"]
    so = native.lib()
    assert so.sn_version() == b"saro_native 0.1.0"
    assert all(hasattr(so, f) for f in native.CORE_SIGNATURES)
    assert not any(hasattr(so, f) for f in native.IMAGE_SIGNATURES)
    res = subprocess.run(["readelf", "-d", native.SO_PATH],
                         capture_output=True, text=True, check=True)
    needed = [ln.split("[")[1].rstrip("]") for ln in res.stdout.splitlines()
              if "(NEEDED)" in ln]
    assert needed and not any(n.startswith(("libpng", "libjpeg", "libz"))
                              for n in needed), needed


@pytest.fixture
def image_build_fails(tmp_path, monkeypatch):
    """The image library built from a source that includes a header no
    host has, into a directory of the test's, its remembered state
    cleared; the core library loaded before, from the real sources."""
    native.lib()
    src = tmp_path / "image_missing_header.cpp"
    src.write_text('#include "saro_native.h"\n'
                   "#include <saro_no_such_header.h>\n")
    monkeypatch.setattr(native, "image_sources", lambda: [str(src)])
    monkeypatch.setattr(native, "IMAGE_SO_PATH",
                        str(tmp_path / "out" / "libimage.so"))
    monkeypatch.setattr(native, "_IMAGE", None)
    monkeypatch.setattr(native, "IMAGE_ERROR", None)


def test_failed_image_build_keeps_colmap_native(image_build_fails, tmp_path,
                                                rng, capsys, python_paths):
    """Without the image library: its build raises with the compiler's
    error, the COLMAP readers and the knn still run natively and equal the
    Python paths, the loader and a camera decode through PIL (equal to the
    bit to SARO_NATIVE=0), and the reason is printed once on stderr."""
    with pytest.raises(RuntimeError, match="saro_no_such_header.h"):
        native.build_image()
    _write_colmap(tmp_path, rng)
    p3d, cams_bin, imgs_bin = (str(tmp_path / f) for f in
                               ("points3D.bin", "cameras.bin", "images.bin"))
    assert native.read_points3d_bin(p3d) is not None
    assert native.read_cameras_bin(cams_bin) is not None
    assert native.read_images_bin(imgs_bin) is not None
    pts = rng.randn(500, 3).astype(np.float32)
    nn = native.nn_distance(pts)
    assert nn is not None
    nat = (colmap.read_points3d_binary(p3d),
           colmap.read_cameras_binary(cams_bin),
           colmap.read_images_binary(imgs_bin))

    same = [_png(tmp_path, rng, size=(16, 12), alpha=True,
                 name=f"s{i}.png")[0] for i in range(4)]
    cams = [cameras.Camera(uid=i, R=np.eye(3), T=np.array([0, 0, 4.0]),
                           fovx=1.0, fovy=0.8, width=8, height=6,
                           image_path=p) for i, p in enumerate(same)]
    loader = dataset.BatchLoader(cams, 4, white_background=True,
                                 shuffle=False, num_workers=1)
    try:
        first = loader._load_batch(np.arange(4)).gt
        again = loader._load_batch(np.arange(4)).gt
        one = cams[0].load_image(True)
        assert native.image_lib() is None and not native.image_available()
        err = capsys.readouterr().err
        python_paths()
        py = loader._load_batch(np.arange(4)).gt
    finally:
        loader.close()
    np.testing.assert_array_equal(first, py)
    np.testing.assert_array_equal(again, py)
    np.testing.assert_array_equal(
        one, cameras.load_image_pil(same[0], 8, 6, white_background=True))
    lines = [ln for ln in err.splitlines() if "image decoders are off" in ln]
    assert len(lines) == 1 and "saro_no_such_header.h" in lines[0], err
    assert "saro_no_such_header.h" in native.IMAGE_ERROR

    py_colmap = (colmap.read_points3d_binary(p3d),
                 colmap.read_cameras_binary(cams_bin),
                 colmap.read_images_binary(imgs_bin))
    for a, b in zip(nat[0], py_colmap[0]):
        np.testing.assert_array_equal(a, b)
    for cid in py_colmap[1]:
        np.testing.assert_array_equal(nat[1][cid].params,
                                      py_colmap[1][cid].params)
        assert nat[1][cid][:4] == py_colmap[1][cid][:4]
    assert nat[2].keys() == py_colmap[2].keys()
    for iid in nat[2]:
        a, b = nat[2][iid], py_colmap[2][iid]
        assert (a.name, a.camera_id) == (b.name, b.camera_id)
        np.testing.assert_array_equal(a.qvec, b.qvec)
        np.testing.assert_array_equal(a.tvec, b.tvec)
    np.testing.assert_allclose(pointcloud._nn_distance(pts, "cpu"), nn,
                               rtol=1e-5, atol=1e-6)


def test_disabled_turns_both_libraries_off(tmp_path, rng, monkeypatch,
                                           capsys):
    """SARO_NATIVE=0: neither library is loaded or built, the readers
    parse in Python what was written, a camera decodes through PIL, and
    nothing is printed."""
    monkeypatch.setenv("SARO_NATIVE", "0")
    monkeypatch.setattr(native, "IMAGE_SO_PATH",
                        str(tmp_path / "out" / "libimage.so"))
    assert native.lib() is None and native.image_lib() is None
    assert not native.available() and not native.image_available()
    assert not os.path.exists(tmp_path / "out")
    n = 30
    xyz = rng.randn(n, 3)
    rgb = rng.randint(0, 255, (n, 3)).astype(np.uint8)
    colmap.write_points3d_binary(xyz, rgb, tmp_path / "points3D.bin")
    assert native.read_points3d_bin(str(tmp_path / "points3D.bin")) is None
    got_xyz, got_rgb, _ = colmap.read_points3d_binary(
        str(tmp_path / "points3D.bin"))
    np.testing.assert_array_equal(got_xyz, xyz)
    np.testing.assert_array_equal(got_rgb, rgb)
    path, _ = _png(tmp_path, rng, size=(20, 10))
    assert native.load_image(path, 20, 10) is None
    assert native.load_images([path], 20, 10) is None
    cam = cameras.Camera(uid=0, R=np.eye(3), T=np.zeros(3), fovx=1.0,
                         fovy=1.0, width=20, height=10, image_path=path)
    np.testing.assert_array_equal(cam.load_image(),
                                  cameras.load_image_pil(path, 20, 10))
    assert "image decoders are off" not in capsys.readouterr().err
