"""The port's mesh and array readers, its four other loaders, its PLY
export and its metrics logger, held against the JAX package's originals
on files the tests write (numpy inputs from a seed; no download is ever
made): every array bit-equal, every written file byte-equal.

- ``data.io``: ``read_off`` (with the headerless ``OFFn v f e`` quirk),
  ``read_obj`` (fan triangulation, ``v/vt`` records), ``read_ply`` (ascii;
  binary, whose face lists the JAX reader cannot read: there the port is
  held to the arrays written), ``read_txt_array``, ``extract_zip``;
- ``ModelNet``, ``ShapeNet``, ``SHREC`` (``split10``) and ``ShapeSeg``
  (its composite archive, as ``tests/data/test_datasets.py`` builds it):
  the processed clouds of every split, the cache reload, the batches;
- ``edge_to_vertex_labels``;
- ``utils.ply_export``: ``write_ply`` (ascii, binary), ``save_ply`` and
  ``save_feature`` (torch tensors too);
- ``training.logging``: ``metrics.jsonl`` and ``settings.txt``.
"""

import argparse
import importlib
import io
import json
import os
import zipfile

import numpy as np
import pytest
import torch

import deltaconv_tpu.data as jdata
import deltaconv_tpu.data.io as jio
import deltaconv_tpu.transforms as jtf
import deltaconv_tpu_torch.data as data
import deltaconv_tpu_torch.data.io as pio
import deltaconv_tpu_torch.transforms as tf
from deltaconv_tpu.data.shapeseg import \
    edge_to_vertex_labels as jax_edge_to_vertex_labels
from deltaconv_tpu.training import MetricsLogger as JaxMetricsLogger
from deltaconv_tpu_torch.data.shapeseg import edge_to_vertex_labels
from deltaconv_tpu_torch.training import MetricsLogger
from deltaconv_tpu_torch.utils import ply_export

jply = importlib.import_module("deltaconv_tpu.utils.ply_export")

torch.set_num_threads(1)


def _same(a, b):
    """Two Clouds (or batch dicts) field by field, exactly."""
    a = a if isinstance(a, dict) else vars(a)
    b = b if isinstance(b, dict) else vars(b)
    assert sorted(a) == sorted(b)
    for k in a:
        if a[k] is None or b[k] is None:
            assert a[k] is None and b[k] is None, k
        else:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=k)


def _write_off(path, rng, nv=20, nf=10, headerless=False):
    v = rng.random((nv, 3))
    f = rng.integers(0, nv, (nf, 3))
    with open(path, "w") as fh:
        if headerless:
            fh.write(f"OFF{nv} {nf} 0\n")
        else:
            fh.write(f"OFF\n{nv} {nf} 0\n")
        for row in v:
            fh.write(" ".join(f"{x:.6f}" for x in row) + "\n")
        for row in f:
            fh.write("3 " + " ".join(str(i) for i in row) + "\n")


def _obj_text(rng, nv=12):
    lines = [f"v {a:.6f} {b:.6f} {c:.6f}" for a, b, c in rng.random((nv, 3))]
    lines += ["vn 0 0 1", "# a comment"]
    lines += ["f 1 2 3", "f 2/1 3/2 4/3 5/4", "f 6//1 7//1 8//1",
              "f 9 10 11 12"]
    return "\n".join(lines) + "\n"


def _ply_ascii(pos, faces):
    lines = ["ply", "format ascii 1.0", "comment a test mesh",
             f"element vertex {len(pos)}", "property float x",
             "property float y", "property float z",
             f"element face {len(faces)}",
             "property list uchar int vertex_indices", "end_header"]
    lines += [" ".join(f"{x:.6f}" for x in p) for p in pos]
    lines += ["3 " + " ".join(str(i) for i in f) for f in faces]
    return ("\n".join(lines) + "\n").encode()


def _ply_binary(pos, faces):
    head = ["ply", "format binary_little_endian 1.0",
            f"element vertex {len(pos)}", "property float x",
            "property float y", "property float z", "property uchar red",
            f"element face {len(faces)}",
            "property list uchar int vertex_indices", "end_header"]
    body = b"".join(np.asarray(p, "<f4").tobytes() + bytes([7])
                    for p in pos)
    body += b"".join(bytes([3]) + np.asarray(f, "<i4").tobytes()
                     for f in faces)
    return ("\n".join(head) + "\n").encode() + body


# -- readers -----------------------------------------------------------------


@pytest.mark.parametrize("headerless", [False, True])
def test_read_off_matches_jax(tmp_path, headerless):
    p = tmp_path / "m.off"
    _write_off(p, np.random.default_rng(0), headerless=headerless)
    got, want = pio.read_off(str(p)), jio.read_off(str(p))
    assert got.pos.shape == (20, 3) and got.face.shape == (3, 10)
    _same(got, want)


def test_read_obj_matches_jax(tmp_path):
    p = tmp_path / "m.obj"
    p.write_text(_obj_text(np.random.default_rng(1)))
    got, want = pio.read_obj(str(p)), jio.read_obj(str(p))
    assert got.face.shape == (3, 6)  # 1 + 2 + 1 + 2 fan triangles
    _same(got, want)


@pytest.mark.parametrize("fmt", ["ascii", "binary"])
def test_read_ply_matches_jax(tmp_path, fmt):
    rng = np.random.default_rng(2)
    pos = rng.random((9, 3)).astype(np.float32)
    faces = rng.integers(0, 9, (5, 3))
    p = tmp_path / "m.ply"
    p.write_bytes((_ply_ascii if fmt == "ascii" else _ply_binary)(pos, faces))
    got = pio.read_ply(str(p))
    assert got.pos.shape == (9, 3) and got.face.shape == (3, 5)
    np.testing.assert_array_equal(got.face, faces.T)
    if fmt == "ascii":
        _same(got, jio.read_ply(str(p)))
    else:
        np.testing.assert_array_equal(got.pos, pos)
        # The JAX reader reads a binary face list's types one field off
        # and raises; the port's reads them from the header's fields.
        with pytest.raises(KeyError):
            jio.read_ply(str(p))
    bad = tmp_path / "bad.ply"
    bad.write_bytes(b"not a ply\n")
    with pytest.raises(ValueError, match="not a PLY"):
        pio.read_ply(str(bad))


def test_read_txt_array_and_extract_zip_match_jax(tmp_path):
    arr = np.random.default_rng(3).random((7, 4))
    np.savetxt(tmp_path / "a.txt", arr)
    for dtype in (np.float32, np.float64):
        got = pio.read_txt_array(str(tmp_path / "a.txt"), dtype)
        want = jio.read_txt_array(str(tmp_path / "a.txt"), dtype)
        assert got.dtype == want.dtype == dtype
        np.testing.assert_array_equal(got, want)
    with zipfile.ZipFile(tmp_path / "z.zip", "w") as z:
        z.writestr("d/x.txt", "1 2 3\n")
    pio.extract_zip(str(tmp_path / "z.zip"), str(tmp_path / "out"))
    assert (tmp_path / "out" / "d" / "x.txt").read_text() == "1 2 3\n"


# -- loaders -----------------------------------------------------------------


def _modelnet_raw(root, rng):
    for cat in ("chair", "table", "bed"):
        for split in ("train", "test"):
            d = root / "raw" / cat / split
            os.makedirs(d)
            for i in range(3):
                _write_off(d / f"{cat}_{i:04d}.off", rng,
                           headerless=i == 1)
    open(root / "raw" / ".extracted", "w").close()


@pytest.mark.parametrize("n_per_class", [None, 1])
def test_modelnet_matches_jax(tmp_path, n_per_class):
    for pkg in ("port", "jax"):
        _modelnet_raw(tmp_path / pkg, np.random.default_rng(4))

    def pre(m):
        return m.Compose([m.NormalizeScale(),
                          m.SamplePoints(48, include_normals=True, seed=0)])

    ports = {}
    for split in ("train", "test"):
        got = ports[split] = data.ModelNet(
            str(tmp_path / "port"), name="40", split=split,
            n_per_class=n_per_class, pre_transform=pre(tf))
        want = jdata.ModelNet(str(tmp_path / "jax"), name="40", split=split,
                              n_per_class=n_per_class,
                              pre_transform=pre(jtf))
        assert got.categories() == want.categories() == ["bed", "chair",
                                                          "table"]
        assert got.processed_prefix == want.processed_prefix == "modelnet40_"
        # n_per_class keeps n + 1 meshes a category (the JAX loader's cap).
        assert len(got) == len(want) == (6 if n_per_class else 9)
        for i in range(len(got)):
            _same(got[i], want[i])
        _same(data.BatchLoader.collate([got[i] for i in range(3)]),
              jdata.BatchLoader.collate([want[i] for i in range(3)]))
    # The cache reloads without the raw tree.
    os.remove(tmp_path / "port" / "raw" / "bed" / "train" / "bed_0000.off")
    again = data.ModelNet(str(tmp_path / "port"), name="40", split="train")
    assert len(again) == len(ports["train"])
    for i in range(len(again)):
        _same(again[i], ports["train"][i])


def _shapenet_raw(root, rng):
    raw = root / "raw"
    names = []
    for cid in ("02691156", "02773838", "02954340"):  # Airplane, Bag, Cap
        os.makedirs(raw / cid)
        for i in range(2):
            arr = np.concatenate([rng.random((30, 6)), rng.integers(
                0, 4, (30, 1)).astype(float)], axis=1)
            np.savetxt(raw / f"{cid}/model{i}.txt", arr)
            names.append(f"shape_data/{cid}/model{i}")
    split_dir = raw / "train_test_split"
    os.makedirs(split_dir)
    for split, sel in (("train", names[:3]), ("val", names[3:4]),
                       ("test", names[4:])):
        with open(split_dir / f"shuffled_{split}_file_list.json", "w") as f:
            json.dump(sel, f)
    open(raw / ".extracted", "w").close()


@pytest.mark.parametrize("categories,normals", [(None, True),
                                                ("Bag", False)])
def test_shapenet_matches_jax(tmp_path, categories, normals):
    for pkg in ("port", "jax"):
        _shapenet_raw(tmp_path / pkg, np.random.default_rng(5))
    for split in ("trainval", "train", "val", "test"):
        got = data.ShapeNet(str(tmp_path / "port"), categories=categories,
                            split=split, include_normals=normals)
        want = jdata.ShapeNet(str(tmp_path / "jax"), categories=categories,
                              split=split, include_normals=normals)
        assert got.num_classes == want.num_classes == 50
        assert got.processed_prefix == want.processed_prefix
        assert len(got) == len(want)
        for i in range(len(got)):
            _same(got[i], want[i])
        if len(got):
            _same(data.BatchLoader.collate([got[i] for i in range(len(got))]),
                  jdata.BatchLoader.collate([want[i]
                                             for i in range(len(want))]))
    assert data.ShapeNet.category_ids == jdata.ShapeNet.category_ids
    assert data.ShapeNet.seg_classes == jdata.ShapeNet.seg_classes


def _shrec_zip(path, rng):
    with zipfile.ZipFile(path, "w") as z:
        for cls in ("alien", "ants", "camel"):
            for split, count in (("train", 13), ("test", 2)):
                for i in range(count):
                    z.writestr(f"shrec_16/{cls}/{split}/T{i}.obj",
                               _obj_text(rng))


@pytest.mark.parametrize("split10", [True, False])
def test_shrec_matches_jax(tmp_path, split10):
    for pkg in ("port", "jax"):
        os.makedirs(tmp_path / pkg / "raw")
        _shrec_zip(tmp_path / pkg / "raw" / "shrec_16.zip",
                   np.random.default_rng(6))
    for split in ("train", "test"):
        got = data.SHREC(str(tmp_path / "port"), split=split,
                         split10=split10, split_seed=3)
        want = jdata.SHREC(str(tmp_path / "jax"), split=split,
                           split10=split10, split_seed=3)
        assert got.num_classes == want.num_classes == 30
        assert got.processed_prefix == want.processed_prefix
        assert len(got) == len(want) == (
            (30 if split10 else 39) if split == "train" else 6)
        for i in range(len(got)):
            _same(got[i], want[i])


def _shapeseg_archive(rng):
    """A miniature shapeseg.zip with the composite layout of the
    reference archive: per-source inner zips of meshes and labels."""
    faces = [(0, 1, 2), (1, 3, 2)]

    def pos():
        return rng.random((4, 3)).astype(np.float32)

    def pt(arr):
        buf = io.BytesIO()
        torch.save(torch.as_tensor(arr), buf)
        return buf.getvalue()

    def inner(entries):
        buf = io.BytesIO()
        with zipfile.ZipFile(buf, "w") as z:
            for name, payload in entries:
                z.writestr(name, payload)
        return buf.getvalue()

    shared = rng.integers(0, 8, 4).astype(np.int64)
    adobe = [e for i in range(41) for e in (
        (f"meshes/{i}.ply", _ply_ascii(pos(), faces)),
        (f"segs/{i}.pt", pt(rng.integers(0, 8, 4).astype(np.int64))))]
    faust = [(f"meshes/tr_reg_{i:03d}.ply", _ply_ascii(pos(), faces))
             for i in range(100)] + [("segs/faust_seg.pt", pt(shared))]
    mit = []
    for name in ("crane0", "march10"):
        text = "\n".join(f"v {a:.6f} {b:.6f} {c:.6f}" for a, b, c in pos())
        mit.append((f"meshes/{name}.obj", text + "\nf 1 2 3\nf 2 4 3\n"))
        mit.append((f"segs/{name}.eseg", "\n".join(
            str(v) for v in rng.integers(1, 9, 5)) + "\n"))
    scape = [(f"meshes/{i}.ply", _ply_ascii(pos(), faces))
             for i in range(71)] + [("segs/scape_seg.pt", pt(shared))]
    shrec = [e for i in range(18) for e in (
        (f"meshes/{i}.ply", _ply_ascii(pos(), faces)),
        (f"segs/{i}.pt", pt(rng.integers(0, 8, 4).astype(np.int64))))]
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as z:
        for name, entries in (("Adobe/raw/adobe.zip", adobe),
                              ("FAUST/raw/faust.zip", faust),
                              ("MIT/raw/mit.zip", mit),
                              ("SCAPE/raw/scape.zip", scape),
                              ("SHREC/raw/shrec.zip", shrec)):
            z.writestr("ShapeSeg/" + name, inner(entries))
    return buf.getvalue()


def test_shapeseg_matches_jax(tmp_path):
    archive = _shapeseg_archive(np.random.default_rng(7))
    for pkg in ("port", "jax"):
        os.makedirs(tmp_path / pkg / "raw")
        (tmp_path / pkg / "raw" / "shapeseg.zip").write_bytes(archive)
    for split, count in (("train", 41 + 100 + 2 + 71), ("test", 18)):
        got = data.ShapeSeg(str(tmp_path / "port"), split=split)
        want = jdata.ShapeSeg(str(tmp_path / "jax"), split=split)
        assert got.num_classes == want.num_classes == 8
        assert len(got) == len(want) == count
        for i in range(count):
            _same(got[i], want[i])
    assert not os.path.exists(tmp_path / "port" / "raw" / "ShapeSeg")


def test_edge_to_vertex_labels_matches_jax():
    rng = np.random.default_rng(8)
    face = rng.integers(0, 12, (3, 15)).astype(np.int64)
    labels = rng.integers(1, 9, 45).astype(np.int64)
    got = edge_to_vertex_labels(face, labels, 12)
    want = jax_edge_to_vertex_labels(face, labels, 12)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_scanobjectnn_asks_for_the_manual_download(tmp_path):
    with pytest.raises(RuntimeError, match="manual download"):
        data.ScanObjectNN(str(tmp_path / "missing"), split="train")


# -- PLY export ----------------------------------------------------------------


def _cloud(rng, n=11, c=3):
    pos = rng.standard_normal((n, 3)).astype(np.float32)
    nrm = rng.standard_normal((n, 3)).astype(np.float32)
    return (pos, nrm, rng.standard_normal((n, 3)).astype(np.float32),
            rng.standard_normal((n, 3)).astype(np.float32),
            rng.standard_normal((n, c)).astype(np.float32),
            rng.standard_normal((n, 2, c)).astype(np.float32),
            rng.integers(0, 5, n))


@pytest.mark.parametrize("binary", [False, True])
def test_ply_export_is_byte_equal_to_jax(tmp_path, binary):
    pos, nrm, xb, yb, xs, vs, y = _cloud(np.random.default_rng(9))
    color = np.random.default_rng(10).integers(0, 255, (11, 3))
    fields = [("x", pos[:, 0]), ("i", y), ("s", xs[:, 1].astype(np.float64))]
    ply_export.write_ply(str(tmp_path / "w_port.ply"), fields, binary)
    jply.write_ply(str(tmp_path / "w_jax.ply"), fields, binary)
    ply_export.save_ply(str(tmp_path / "s_port.ply"), torch.from_numpy(pos),
                        nrm, vs[:, 0], color, y, xs[:, 0], binary)
    jply.save_ply(str(tmp_path / "s_jax.ply"), pos, nrm, vs[:, 0], color, y,
                  xs[:, 0], binary)
    ply_export.save_feature(str(tmp_path / "f_port"), pos,
                            torch.from_numpy(nrm), xb, yb,
                            torch.from_numpy(xs), vs, 2, y, binary)
    jply.save_feature(str(tmp_path / "f_jax"), pos, nrm, xb, yb, xs, vs, 2,
                      y, binary)
    names = ["w_{}.ply", "s_{}.ply"] + [f"f_{{}}_shape2_feat{j}.ply"
                                        for j in range(3)]
    for name in names:
        got = (tmp_path / name.format("port")).read_bytes()
        assert got == (tmp_path / name.format("jax")).read_bytes(), name
        assert len(got) > 100


# -- logging -------------------------------------------------------------------


def test_metrics_logger_files_equal_jax(tmp_path):
    args = argparse.Namespace(lr=0.001, k=20, data_root="/data/x",
                              augmentation=None, background=False)
    for pkg, cls in (("port", MetricsLogger), ("jax", JaxMetricsLogger)):
        logger = cls(str(tmp_path / pkg))
        logger.write_settings(args, "scanobjectnn")
        logger.add_scalar("training loss", np.float32(0.123456789), 50)
        logger.add_scalar("test accuracy", 0.75, 1)
        logger.add_scalar("training accuracy", torch.tensor(0.5), 2)
        logger.close()
        silent = cls(None)
        silent.add_scalar("x", 1.0, 1)
        silent.write_settings(args, "x")
        silent.close()
    for name in ("metrics.jsonl", "settings.txt"):
        got = (tmp_path / "port" / name).read_text()
        assert got == (tmp_path / "jax" / name).read_text(), name
    assert len((tmp_path / "port" / "metrics.jsonl").read_text()
               .splitlines()) == 3
