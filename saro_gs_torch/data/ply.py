"""Binary-little-endian PLY reading, numpy only.

Reads the Gaussian checkpoint layout (x,y,z, nx,ny,nz, f_dc_*, f_rest_*,
opacity, scale_*, rot_*, temporal_pos) written by the JAX package's
``save_gaussian_ply``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

_DTYPES = {"float": "<f4", "double": "<f8", "uchar": "u1", "int": "<i4",
           "uint": "<u4", "short": "<i2", "ushort": "<u2", "char": "i1",
           "float32": "<f4", "float64": "<f8", "uint8": "u1", "int32": "<i4"}


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
