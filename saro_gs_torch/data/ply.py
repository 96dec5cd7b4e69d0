"""Binary-little-endian PLY files, numpy only (counterpart of
data/ply.py; the two packages write the same bytes).

Two layouts: xyzt + rgb point clouds (dataset_readers.storePly/fetchPly
:307-357: x,y,z,t,nx,ny,nz,red,green,blue) and the Gaussian checkpoint
(saro_gaussian.py:400-447: x,y,z, nx,ny,nz, f_dc_*, f_rest_*, opacity,
scale_*, rot_*, temporal_pos).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

_DTYPES = {"float": "<f4", "double": "<f8", "uchar": "u1", "int": "<i4",
           "uint": "<u4", "short": "<i2", "ushort": "<u2", "char": "i1",
           "float32": "<f4", "float64": "<f8", "uint8": "u1", "int32": "<i4"}


def write_ply(path, fields: List[Tuple[str, np.ndarray]]):
    """fields: (name, [N] array) pairs, written as one 'vertex' element:
    uint8 arrays as uchar, everything else as float."""
    n = fields[0][1].shape[0]
    dtype = []
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}"]
    for name, arr in fields:
        if arr.shape != (n,):
            raise ValueError(f"field {name} has shape {arr.shape}, "
                             f"expected ({n},)")
        if arr.dtype == np.uint8:
            header.append(f"property uchar {name}")
            dtype.append((name, "u1"))
        else:
            header.append(f"property float {name}")
            dtype.append((name, "<f4"))
    header.append("end_header")
    rec = np.empty(n, dtype=dtype)
    for name, arr in fields:
        rec[name] = arr if arr.dtype == np.uint8 else arr.astype("<f4")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(rec.tobytes())


def read_ply(path) -> Dict[str, np.ndarray]:
    """Returns {property_name: [N] array} of the 'vertex' element."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.find(b"end_header\n")
    if end < 0:
        raise ValueError(f"{path}: not a PLY file")
    header = data[:end].decode("ascii").splitlines()
    body = data[end + len(b"end_header\n"):]
    fmt = None
    n = 0
    props = []
    in_vertex = False
    for line in header:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            in_vertex = parts[1] == "vertex"
            if in_vertex:
                n = int(parts[2])
        elif parts[0] == "property" and in_vertex:
            if parts[1] == "list":
                raise ValueError(f"{path}: list properties unsupported")
            props.append((parts[2], _DTYPES[parts[1]]))
    if fmt != "binary_little_endian":
        raise ValueError(f"{path}: unsupported PLY format {fmt}")
    rec = np.frombuffer(body, dtype=props, count=n)
    return {name: np.array(rec[name]) for name, _ in props}


def _indexed(d, prefix):
    keys = sorted([k for k in d if k.startswith(prefix)],
                  key=lambda k: int(k.split("_")[-1]))
    return np.stack([d[k] for k in keys], axis=1)


def load_gaussian_ply(path):
    """Checkpoint PLY -> dict of numpy arrays: xyz [N,3], f_dc [N,1,3],
    f_rest [N,K,3], opacity [N,1], scaling [N,3], rotation [N,4],
    temporal_pos [N,1].  SH bands are stored channel-major."""
    d = read_ply(path)
    n = d["x"].shape[0]
    xyz = np.stack([d["x"], d["y"], d["z"]], axis=1)
    f_dc = _indexed(d, "f_dc_").reshape(n, 3, -1).transpose(0, 2, 1)
    fr = _indexed(d, "f_rest_")
    f_rest = fr.reshape(n, 3, fr.shape[1] // 3).transpose(0, 2, 1)
    return dict(
        xyz=xyz,
        f_dc=f_dc,
        f_rest=f_rest,
        opacity=d["opacity"][:, None],
        scaling=_indexed(d, "scale_"),
        rotation=_indexed(d, "rot_"),
        temporal_pos=d["temporal_pos"][:, None])


def store_point_cloud(path, xyzt: np.ndarray, rgb: np.ndarray):
    """xyzt [N, 4] (position and time), rgb [N, 3] in 0..255, truncated to
    uint8 (dataset_readers.storePly:307-340)."""
    n = xyzt.shape[0]
    normals = np.zeros((n, 3), np.float32)
    write_ply(path, [("x", xyzt[:, 0]), ("y", xyzt[:, 1]),
                     ("z", xyzt[:, 2]), ("t", xyzt[:, 3]),
                     ("nx", normals[:, 0]), ("ny", normals[:, 1]),
                     ("nz", normals[:, 2]),
                     ("red", rgb[:, 0].astype(np.uint8)),
                     ("green", rgb[:, 1].astype(np.uint8)),
                     ("blue", rgb[:, 2].astype(np.uint8))])


def fetch_point_cloud(path):
    """(points [N, 3], colors [N, 3] in [0, 1], times [N, 1] or None), all
    float64."""
    d = read_ply(path)
    pts = np.stack([d["x"], d["y"], d["z"]], axis=1).astype(np.float64)
    colors = np.stack([d["red"], d["green"], d["blue"]],
                      axis=1).astype(np.float64) / 255.0
    times = d["t"].astype(np.float64)[:, None] if "t" in d else None
    return pts, colors, times


def save_gaussian_ply(path, xyz, f_dc, f_rest, opacity, scaling, rotation,
                      temporal_pos):
    """The checkpoint layout of saro_gaussian.save_ply:418-447, numpy
    inputs; f_dc [N,1,3] and f_rest [N,K,3] are stored channel-major."""
    n = xyz.shape[0]
    normals = np.zeros((n, 3), np.float32)
    fields = [("x", xyz[:, 0]), ("y", xyz[:, 1]), ("z", xyz[:, 2]),
              ("nx", normals[:, 0]), ("ny", normals[:, 1]),
              ("nz", normals[:, 2])]
    dc = np.transpose(f_dc, (0, 2, 1)).reshape(n, -1)
    fields += [(f"f_dc_{i}", dc[:, i]) for i in range(dc.shape[1])]
    fr = np.transpose(f_rest, (0, 2, 1)).reshape(n, -1)
    fields += [(f"f_rest_{i}", fr[:, i]) for i in range(fr.shape[1])]
    fields.append(("opacity", opacity[:, 0]))
    fields += [(f"scale_{i}", scaling[:, i]) for i in range(scaling.shape[1])]
    fields += [(f"rot_{i}", rotation[:, i])
               for i in range(rotation.shape[1])]
    fields.append(("temporal_pos", temporal_pos[:, 0]))
    write_ply(path, fields)
