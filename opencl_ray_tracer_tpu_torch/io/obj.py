"""Wavefront OBJ loader: the native C++ parser, and the same in Python.

The subset of the reference loader (``src/cpp/utility.cpp:63-170``): ``v``
and ``f`` records only, triangulated faces in the plain ``f a b c`` and the
9-token ``f a/b/c a/b/c a/b/c`` forms, 1-indexed vertices, a per-mesh scale
and translate applied to the vertices, and the AABB of the transformed
vertices (``utility.cpp:121-127``).  The arrays equal the JAX package's
``io/obj.py`` parser's.  ``load_obj`` reads through the native library
(``io/native.py``, built at first use) as the JAX package's does, and
parses in Python (``parse_obj``) only when the library is turned off
(``OCLRT_NATIVE=0``) or reports an error.
"""

from __future__ import annotations

import numpy as np


def parse_obj(text: str, scale=(1.0, 1.0, 1.0), translate=(0.0, 0.0, 0.0)):
    """OBJ text -> ((T,3,3) f32 triangles, (min(3,), max(3,)) f32 AABB)."""
    scale = np.asarray(scale, np.float32)
    translate = np.asarray(translate, np.float32)
    verts = []
    faces = []
    for line in text.splitlines():
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "v":
            v = np.array([float(parts[1]), float(parts[2]),
                          float(parts[3])], np.float32)
            verts.append(v * scale + translate)
        elif parts[0] == "f":
            # the reference turns spaces into '/' and splits
            # (utility.cpp:134-157): 9 tokens are the a/b/c form, whose
            # vertex index is token 0 of each group
            toks = "/".join(parts[1:]).split("/")
            idx = ((toks[0], toks[3], toks[6]) if len(toks) == 9
                   else (toks[0], toks[1], toks[2]))
            faces.append([int(i) for i in idx])
    verts = np.stack(verts) if verts else np.zeros((0, 3), np.float32)
    if verts.shape[0]:
        aabb = (verts.min(axis=0), verts.max(axis=0))
    else:
        aabb = (np.zeros(3, np.float32), np.zeros(3, np.float32))
    if faces:
        tris = verts[np.asarray(faces, np.int64) - 1]   # utility.cpp:160-162
    else:
        tris = np.zeros((0, 3, 3), np.float32)
    return tris.astype(np.float32), aabb


def load_obj(path: str, scale=(1.0, 1.0, 1.0), translate=(0.0, 0.0, 0.0)):
    """``parse_obj`` of the file at ``path``, through the native parser
    unless it returns None."""
    from .native import load_obj_native
    out = load_obj_native(path, scale, translate)
    if out is not None:
        return out
    with open(path) as f:
        return parse_obj(f.read(), scale, translate)
