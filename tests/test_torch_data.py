"""The port's copies of the JAX package's host-side data modules, held
against their originals on the CPU: each must give exactly the JAX
package's output on the same inputs (numpy, seeded).

- ``data``: the ``Cloud`` container, ``CloudDataset`` (process, cache,
  reload, transform) and ``BatchLoader`` (order, shuffle, epochs, host
  shards, collation), the synthetic generators, and ``ScanObjectNN`` on
  an h5 file the test writes (skipped without ``h5py``);
- ``transforms``: every numpy transform on the same
  ``np.random.Generator`` seed, and ``GeodesicFPS``;
- ``geometry.fps``: ``geodesic_fps`` from the port's own C++ build (never
  the JAX package's library) and its Python fallback, ``euclidean_fps``;
- ``training.metrics``.
"""

import importlib.util

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deltaconv_tpu.data as jdata
import deltaconv_tpu.geometry.fps as jfps
import deltaconv_tpu.training.metrics as jmetrics
import deltaconv_tpu.transforms as jtf
import deltaconv_tpu_torch.data as data
import deltaconv_tpu_torch.geometry.fps as fps
import deltaconv_tpu_torch.training.metrics as metrics
import deltaconv_tpu_torch.transforms as tf
from deltaconv_tpu_torch import cpp
from deltaconv_tpu_torch.cpp import build as cpp_build

torch.set_num_threads(1)


def _mesh(rng, nv=40, nf=60):
    return rng.random((nv, 3)).astype(np.float32), rng.integers(
        0, nv, (3, nf)).astype(np.int64)


def _same(a, b):
    """Two Clouds (or batch dicts) field by field, exactly."""
    a = a if isinstance(a, dict) else vars(a)
    b = b if isinstance(b, dict) else vars(b)
    assert sorted(a) == sorted(b)
    for k in a:
        if a[k] is None or b[k] is None:
            assert a[k] is None and b[k] is None, k
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=k)


# -- transforms ----------------------------------------------------------------


def _transforms(pkg):
    return [
        ("NormalizeScale", pkg.NormalizeScale(), False),
        ("NormalizeScale-inf", pkg.NormalizeScale(norm_ord=np.inf), False),
        ("NormalizeArea", pkg.NormalizeArea(), True),
        ("NormalizeAxes", pkg.NormalizeAxes(), False),
        ("RandomScale", pkg.RandomScale((0.8, 1.25)), False),
        ("RandomRotate", pkg.RandomRotate(30, axis=1), False),
        ("RandomTranslateGlobal", pkg.RandomTranslateGlobal(0.1), False),
        ("RandomNormals", pkg.RandomNormals(0.05), False),
        ("SamplePoints", pkg.SamplePoints(64, include_normals=True,
                                          include_labels=True), True),
        ("Compose", pkg.Compose([pkg.NormalizeScale(),
                                 pkg.RandomScale((0.5, 2.0)),
                                 pkg.RandomRotate(180, axis=2)]), False),
    ]


@pytest.mark.parametrize("index", range(10))
def test_transform_matches_jax(index):
    name, port_t, mesh = _transforms(tf)[index]
    jname, jax_t, _ = _transforms(jtf)[index]
    assert name == jname
    rng = np.random.default_rng(index)
    pos, face = _mesh(rng)
    nrm = rng.standard_normal(pos.shape).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    y = rng.integers(0, 4, pos.shape[0])
    kw = dict(pos=pos, normal=nrm, y=y, face=face if mesh else None)
    got = port_t(data.Cloud(**kw), np.random.default_rng(100))
    want = jax_t(jdata.Cloud(**kw), np.random.default_rng(100))
    _same(got, want)


def test_geodesic_fps_transform_matches_jax():
    rng = np.random.default_rng(11)
    pos = rng.standard_normal((300, 3)).astype(np.float32)
    y = rng.integers(0, 5, 300)
    for n_samples, store in ((128, False), (400, True)):  # 400: tiled
        got = tf.GeodesicFPS(n_samples, store_original=store, seed=3)(
            data.Cloud(pos=pos, y=y))
        want = jtf.GeodesicFPS(n_samples, store_original=store, seed=3)(
            jdata.Cloud(pos=pos, y=y))
        _same(got, want)
        assert got.pos.shape == (n_samples, 3)


# -- geometry.fps ------------------------------------------------------------------


def test_geodesic_fps_uses_the_ports_own_build():
    lib = cpp.load_library()
    assert lib is not None, "g++ could not build the port's geodesic_fps"
    assert lib._name == str(cpp_build._SO)
    assert "deltaconv_tpu_torch" in lib._name
    assert cpp_build._SRC.read_bytes() == (
        cpp_build._SRC.parents[2] / "deltaconv_tpu" / "cpp"
        / "geodesic_fps.cpp").read_bytes()


@pytest.mark.parametrize("n,samples,k", [(500, 64, 10), (50, 50, 10),
                                         (12, 5, 20)])
def test_geodesic_fps_matches_jax(n, samples, k):
    pts = np.random.default_rng(n).standard_normal((n, 3))
    got = fps.geodesic_fps(pts, samples, knn_k=k, seed=7)
    want = jfps.geodesic_fps(pts, samples, knn_k=k, seed=7)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) == samples


def test_geodesic_fps_python_fallback_matches_jax():
    pts = np.ascontiguousarray(
        np.random.default_rng(12).standard_normal((80, 3)))
    np.testing.assert_array_equal(
        fps._geodesic_fps_python(pts, 20, 10, 5),
        jfps._geodesic_fps_python(pts, 20, 10, 5))
    with pytest.raises(ValueError, match="n_samples"):
        fps.geodesic_fps(pts, 81)
    with pytest.raises(ValueError, match=r"\[N, 3\]"):
        fps.geodesic_fps(pts[:, :2], 5)


@pytest.mark.parametrize("start", [0, 17])
def test_euclidean_fps_matches_jax(start):
    pos = np.random.default_rng(13).standard_normal((400, 3)).astype(
        np.float32)
    got = fps.euclidean_fps(torch.from_numpy(pos), 64, start)
    want = np.asarray(jfps.euclidean_fps(jnp.asarray(pos), 64, start))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# -- data -------------------------------------------------------------------------


def test_synthetic_generators_match_jax():
    for name in ("synthetic_classification_batch",
                 "synthetic_segmentation_batch"):
        _same(getattr(data, name)(3, 4, 50), getattr(jdata, name)(3, 4, 50))
    _same(data.synthetic_classification_batch(1, 2, 30, with_normals=False),
          jdata.synthetic_classification_batch(1, 2, 30, with_normals=False))
    got = data.synthetic_seg_shapes(np.random.default_rng(2), 3, 40)
    want = jdata.synthetic_seg_shapes(np.random.default_rng(2), 3, 40)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _dataset_class(base, cloud_cls):
    class Toy(base):
        """Eleven random clouds a split."""

        def download(self):
            pass

        def process(self):
            rng = np.random.default_rng(0)
            return {split: self._apply_pre([
                cloud_cls(pos=rng.standard_normal((32, 3)).astype(
                    np.float32), y=np.int64(i % 3)) for i in range(11)])
                for split in self.split_names}

    return Toy


def _datasets(tmp_path, transforms=lambda pkg: {}, **kw):
    """The toy dataset in both packages, each with ``transforms(pkg)`` of
    its own package."""
    port = _dataset_class(data.CloudDataset, data.Cloud)(
        str(tmp_path / "port"), **transforms(tf), **kw)
    want = _dataset_class(jdata.CloudDataset, jdata.Cloud)(
        str(tmp_path / "jax"), **transforms(jtf), **kw)
    return port, want


def test_cloud_dataset_matches_jax(tmp_path):
    port, want = _datasets(tmp_path, lambda pkg: dict(
        pre_transform=pkg.NormalizeScale(),
        transform=pkg.RandomScale((0.9, 1.1), seed=4)), split="test")
    assert len(port) == len(want) == 11
    for i in range(len(port)):
        _same(port[i], want[i])
    # The cache: a second construction loads what the first processed.
    again = _dataset_class(data.CloudDataset, data.Cloud)(
        str(tmp_path / "port"), split="test")
    _same(again._clouds[3], port._clouds[3])
    with pytest.raises(ValueError, match="split"):
        _dataset_class(data.CloudDataset, data.Cloud)(
            str(tmp_path / "port"), split="val")


@pytest.mark.parametrize("case", ["ordered", "shuffled", "epochs", "hosts",
                                  "keep-last"])
def test_batch_loader_matches_jax(tmp_path, case):
    port_ds, jax_ds = _datasets(tmp_path)
    kw = {"ordered": dict(batch_size=4),
          "shuffled": dict(batch_size=3, shuffle=True, seed=5),
          "epochs": dict(batch_size=2, shuffle=True, seed=6),
          "hosts": dict(batch_size=2, shuffle=True, seed=7, host_shard=True,
                        process_index=1, process_count=2),
          "keep-last": dict(batch_size=4, drop_last=False)}[case]
    got_loader = data.BatchLoader(port_ds, **kw)
    want_loader = jdata.BatchLoader(jax_ds, **kw)
    assert len(got_loader) == len(want_loader)
    for epoch in range(2):
        if case == "epochs":
            got_loader.set_epoch(epoch)
            want_loader.set_epoch(epoch)
        got, want = list(got_loader), list(want_loader)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            _same(g, w)


def test_host_shard_defaults_come_from_torch_distributed(tmp_path):
    """Without an initialized process group a host is shard 0 of 1; an
    explicit count with a defaulted index keeps the index at the rank."""
    port_ds, _ = _datasets(tmp_path)
    loader = data.BatchLoader(port_ds, 2, host_shard=True)
    assert (loader.process_index, loader.process_count) == (0, 1)
    loader = data.BatchLoader(port_ds, 2, host_shard=True, process_count=2)
    assert (loader.process_index, loader.process_count) == (0, 2)
    with pytest.raises(ValueError, match="drop_last"):
        data.BatchLoader(port_ds, 2, drop_last=False, process_index=0,
                         process_count=2)


def test_scanobjectnn_matches_jax(tmp_path):
    if importlib.util.find_spec("h5py") is None:
        pytest.skip("h5py is not installed")
    import h5py

    files = data.ScanObjectNN.raw_file_dict["PB_T25"]
    for root in ("port", "jax"):
        raw = tmp_path / root / "raw" / "main_split_nobg"
        raw.mkdir(parents=True)
        for i, name in enumerate(files):
            with h5py.File(raw / name, "w") as h5:
                h5["data"] = np.random.default_rng(i).standard_normal(
                    (5, 64, 3)).astype(np.float32)
                h5["label"] = np.arange(5) * (i + 2) % 15
    pre = dict(port=tf.GeodesicFPS(32, seed=1),
               jax=jtf.GeodesicFPS(32, seed=1))
    for split in ("train", "test"):
        got = data.ScanObjectNN(str(tmp_path / "port"), augmentation="PB_T25",
                                split=split, pre_transform=pre["port"])
        want = jdata.ScanObjectNN(str(tmp_path / "jax"),
                                  augmentation="PB_T25", split=split,
                                  pre_transform=pre["jax"])
        assert len(got) == len(want) == 5 and got.num_classes == 15
        for i in range(5):
            _same(got[i], want[i])
        _same(data.BatchLoader.collate([got[i] for i in range(5)]),
              jdata.BatchLoader.collate([want[i] for i in range(5)]))
    with pytest.raises(RuntimeError, match="manual download"):
        data.ScanObjectNN(str(tmp_path / "empty"))


# -- training.metrics ----------------------------------------------------------------


def test_metrics_match_jax():
    rng = np.random.default_rng(15)
    pred, true = rng.integers(0, 5, 200), rng.integers(0, 5, 200)
    assert metrics.accuracy(pred, true) == jmetrics.accuracy(pred, true)
    assert (metrics.balanced_accuracy(pred, true)
            == jmetrics.balanced_accuracy(pred, true))
    seg_pred, seg = rng.integers(0, 50, (6, 100)), rng.integers(0, 50, (6, 100))
    label = rng.integers(0, 16, 6)
    assert (metrics.shape_iou(seg_pred, seg, label)
            == jmetrics.shape_iou(seg_pred, seg, label))
    assert (metrics.shape_iou(seg_pred % 4, seg % 4, label, "Airplane")
            == jmetrics.shape_iou(seg_pred % 4, seg % 4, label, "Airplane"))
    assert metrics.SHAPENET_SEG_NUM == jmetrics.SHAPENET_SEG_NUM
    assert metrics.SHAPENET_INDEX_START == jmetrics.SHAPENET_INDEX_START
