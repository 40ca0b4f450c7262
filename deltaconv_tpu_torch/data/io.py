"""Mesh / array IO and download helpers (a copy of
``deltaconv_tpu/data/io.py``; numpy only).

Replaces PyG's ``read_off``/``read_ply``/``read_txt_array``/
``download_url``/``extract_zip`` and openmesh's OBJ reading used by the
reference dataset builders (experiments/datasets/*). ``download_url``
checks the server's certificate.
"""

from __future__ import annotations

import os
import struct
import urllib.request
import zipfile
from typing import Optional, Tuple

import numpy as np

from .cloud import Cloud

__all__ = [
    "download_url",
    "extract_zip",
    "read_off",
    "read_obj",
    "read_ply",
    "read_txt_array",
]


def download_url(url: str, folder: str, filename: Optional[str] = None) -> str:
    """Downloads ``url`` into ``folder`` (skips if present)."""
    os.makedirs(folder, exist_ok=True)
    filename = filename or url.rpartition("/")[2].split("?")[0]
    path = os.path.join(folder, filename)
    if os.path.exists(path):
        return path
    tmp = path + ".part"
    with urllib.request.urlopen(url) as r, open(tmp, "wb") as f:
        while True:
            chunk = r.read(1 << 20)
            if not chunk:
                break
            f.write(chunk)
    os.replace(tmp, path)
    return path


def extract_zip(path: str, folder: str) -> None:
    with zipfile.ZipFile(path, "r") as z:
        z.extractall(folder)


def read_off(path: str) -> Cloud:
    """Reads an OFF mesh (handles the headerless 'OFFn v f e' quirk of
    raw ModelNet files)."""
    with open(path, "r") as f:
        header = f.readline().strip()
        if header.startswith("OFF") and len(header) > 3:
            counts = header[3:].split()
        else:
            counts = f.readline().split()
        nv, nf = int(counts[0]), int(counts[1])
        verts = np.empty((nv, 3), np.float32)
        for i in range(nv):
            verts[i] = np.fromstring(f.readline(), sep=" ", count=3)
        faces = np.empty((nf, 3), np.int64)
        for i in range(nf):
            row = f.readline().split()
            faces[i] = [int(row[1]), int(row[2]), int(row[3])]
    return Cloud(pos=verts, face=np.ascontiguousarray(faces.T))


def read_obj(path: str) -> Cloud:
    """Reads a triangular OBJ mesh (v / f records, 1-based indices)."""
    verts, faces = [], []
    with open(path, "r") as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(t) for t in line.split()[1:4]])
            elif line.startswith("f "):
                idx = [int(t.split("/")[0]) - 1 for t in line.split()[1:]]
                for i in range(1, len(idx) - 1):  # fan-triangulate
                    faces.append([idx[0], idx[i], idx[i + 1]])
    pos = np.asarray(verts, np.float32)
    face = np.asarray(faces, np.int64).T if faces else None
    return Cloud(pos=pos, face=face)


_PLY_TYPES = {
    "char": ("b", 1), "int8": ("b", 1),
    "uchar": ("B", 1), "uint8": ("B", 1),
    "short": ("h", 2), "int16": ("h", 2),
    "ushort": ("H", 2), "uint16": ("H", 2),
    "int": ("i", 4), "int32": ("i", 4),
    "uint": ("I", 4), "uint32": ("I", 4),
    "float": ("f", 4), "float32": ("f", 4),
    "double": ("d", 8), "float64": ("d", 8),
}


def read_ply(path: str) -> Cloud:
    """Minimal PLY reader: ascii and binary_little_endian triangle
    meshes with x/y/z vertex properties."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path} is not a PLY file")
        fmt = None
        elements = []  # (name, count, [(prop_type, prop_name) | list-spec])
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("comment"):
                continue
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, count = line.split()
                elements.append([name, int(count), []])
            elif line.startswith("property"):
                toks = line.split()
                if toks[1] == "list":
                    elements[-1][2].append(("list", toks[2], toks[3], toks[4]))
                else:
                    elements[-1][2].append(("scalar", toks[1], toks[2]))
            elif line == "end_header":
                break

        verts = faces = None
        for name, count, props in elements:
            if fmt == "ascii":
                rows = [f.readline().split() for _ in range(count)]
                if name == "vertex":
                    verts = np.array(
                        [[float(r[i]) for i in range(3)] for r in rows],
                        np.float32,
                    )
                elif name == "face":
                    faces = np.array(
                        [[int(t) for t in r[1:4]] for r in rows], np.int64
                    )
            elif fmt == "binary_little_endian":
                if name == "vertex":
                    fmt_str = "<" + "".join(
                        _PLY_TYPES[p[1]][0] for p in props if p[0] == "scalar"
                    )
                    size = struct.calcsize(fmt_str)
                    data = f.read(size * count)
                    arr = np.array(
                        [struct.unpack_from(fmt_str, data, i * size)
                         for i in range(count)]
                    )
                    verts = arr[:, :3].astype(np.float32)
                elif name == "face":
                    # ("list", count type, index type, name); the JAX
                    # reader takes the index type and the name here and
                    # raises KeyError on every binary face list.
                    cnt_t, idx_t = props[0][1], props[0][2]
                    cfmt, csz = _PLY_TYPES[cnt_t]
                    ifmt, isz = _PLY_TYPES[idx_t]
                    rows = []
                    for _ in range(count):
                        k = struct.unpack("<" + cfmt, f.read(csz))[0]
                        rows.append(
                            struct.unpack("<" + ifmt * k, f.read(isz * k))[:3]
                        )
                    faces = np.asarray(rows, np.int64)
            else:
                raise ValueError(f"unsupported PLY format {fmt}")

    if verts is None:
        raise ValueError(f"no vertex element in {path}")
    face = np.ascontiguousarray(faces.T) if faces is not None else None
    return Cloud(pos=verts, face=face)


def read_txt_array(path: str, dtype=np.float32) -> np.ndarray:
    return np.loadtxt(path, dtype=dtype)
