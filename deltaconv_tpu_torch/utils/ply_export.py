"""PLY export for visualization in Blender / Polyscope (a copy of
``deltaconv_tpu/utils/ply_export.py``; the arrays may also be torch
tensors, on any device).

Feature parity with the reference release's visualization/ply_utils.py
(``save_ply``/``save_feature``) without the plyfile dependency: a
self-contained ascii/binary PLY writer over numpy arrays. Tangent
vector features are lifted to ambient space via
``v_x * x_basis + v_y * y_basis`` exactly as the reference
(ply_utils.py:104-106).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = ["write_ply", "save_ply", "save_feature"]


def _host(a):
    """A numpy array of ``a`` (a torch tensor is copied to the host)."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


def write_ply(filename: str, fields: Sequence[Tuple[str, np.ndarray]],
              binary: bool = False) -> None:
    """Writes named per-vertex scalar columns to a PLY file.

    Args:
      filename: output path.
      fields: list of (name, [N] array) columns; float columns are
        written f4, integer columns i4.
      binary: binary_little_endian instead of ascii.
    """
    n = len(fields[0][1])
    cols = []
    dtypes = []
    for name, arr in fields:
        arr = _host(arr).reshape(-1)
        assert len(arr) == n, f"column {name} has length {len(arr)} != {n}"
        if np.issubdtype(arr.dtype, np.integer):
            dtypes.append((name, "<i4"))
            cols.append(arr.astype("<i4"))
        else:
            dtypes.append((name, "<f4"))
            cols.append(arr.astype("<f4"))

    rec = np.rec.fromarrays(cols, dtype=dtypes)
    fmt = "binary_little_endian" if binary else "ascii"
    header = ["ply", f"format {fmt} 1.0", f"element vertex {n}"]
    for name, dt in dtypes:
        kind = "int" if dt == "<i4" else "float"
        header.append(f"property {kind} {name}")
    header.append("end_header")

    with open(filename, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if binary:
            f.write(rec.tobytes())
        else:
            for row in rec:
                f.write((" ".join(str(v) for v in row) + "\n")
                        .encode("ascii"))


def save_ply(filename: str, pos, normal=None, vec=None, color=None,
             y=None, scalar=None, binary: bool = False) -> None:
    """Saves a point cloud with optional per-point attributes.

    Field layout matches the reference (ply_utils.py:4-47):
    x/y/z [+ nx/ny/nz] [+ vx/vy/vz] [+ r/g/b] [+ label] [+ scalar].
    """
    pos = _host(pos)
    fields = [("x", pos[:, 0]), ("y", pos[:, 1]), ("z", pos[:, 2])]
    if normal is not None:
        normal = _host(normal)
        fields += [("nx", normal[:, 0]), ("ny", normal[:, 1]),
                   ("nz", normal[:, 2])]
    if vec is not None:
        vec = _host(vec)
        fields += [("vx", vec[:, 0]), ("vy", vec[:, 1]), ("vz", vec[:, 2])]
    if color is not None:
        color = _host(color)
        fields += [("r", color[:, 0]), ("g", color[:, 1]),
                   ("b", color[:, 2])]
    if y is not None:
        fields.append(("label", _host(y).reshape(-1).astype(np.int32)))
    if scalar is not None:
        fields.append(("scalar", _host(scalar).reshape(-1)))
    write_ply(filename, fields, binary=binary)


def save_feature(filename: str, pos, normal, x_basis, y_basis, xs,
                 vs=None, i: Optional[int] = None, y=None,
                 binary: bool = False) -> None:
    """Exports per-channel DeltaConv features to one PLY per channel.

    Args:
      filename: root; each channel j goes to
        ``{filename}_shape{i}_feat{j}.ply``.
      pos, normal, x_basis, y_basis: ``[N, 3]`` arrays (pass one cloud;
        for batched arrays index the batch first).
      xs: ``[N, C]`` scalar features.
      vs: optional ``[N, 2, C]`` tangent vector features, lifted into
        3D via the local frame.
      i: shape tag used in the filename.
      y: optional ``[N]`` labels.
    """
    pos = _host(pos)
    normal = _host(normal)
    x_basis = _host(x_basis)
    y_basis = _host(y_basis)
    xs = _host(xs)

    base = [("x", pos[:, 0]), ("y", pos[:, 1]), ("z", pos[:, 2]),
            ("nx", normal[:, 0]), ("ny", normal[:, 1]),
            ("nz", normal[:, 2])]
    if y is not None:
        base.append(("label", _host(y).reshape(-1).astype(np.int32)))

    for j in range(xs.shape[1]):
        fields = list(base)
        fields.append(("scalar", xs[:, j]))
        if vs is not None:
            v = _host(vs)[:, :, j]
            v3 = v[:, 0:1] * x_basis + v[:, 1:2] * y_basis
            fields += [("vx", v3[:, 0]), ("vy", v3[:, 1]),
                       ("vz", v3[:, 2])]
        write_ply(f"{filename}_shape{i}_feat{j}.ply", fields, binary=binary)
