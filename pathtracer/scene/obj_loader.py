"""Wavefront OBJ/MTL scene loader.

Capability parity with the reference loader
(`reference/include/utils/file_manager.h:39-273`):
  * MTL: `newmtl`, `Kd` (diffuse rgb), `Ke` (emission). We additionally parse
    `Ks` + `illum`: `illum 5` (or a dominant specular with mirror-style
    shininess) selects the MATERIAL_MIRROR lobe — an additive capability
    (the reference README advertises reflective materials but its code
    never implements them).
  * OBJ: `v`, `vn`, `mtllib`, `usemtl`, `f` with `v`, `v//vn`, `v/vt`,
    `v/vt/vn` index forms; 3-vertex faces become triangles, 4-vertex faces
    become quads, anything else warns and is skipped; the first vertex's `vn`
    (when present) overrides the computed face normal.
Default material: albedo (0.8, 0.8, 0.8), no emission (file_manager.h:24-27).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from ..core.constants import MATERIAL_DIFFUSE, MATERIAL_MIRROR
from ..utils.logger import get_logger
from .mesh import PrimList, make_triangle_corners

log = get_logger("ObjLoader")


@dataclass
class Material:
    albedo: np.ndarray = field(
        default_factory=lambda: np.array([0.8, 0.8, 0.8], np.float32)
    )
    emission: np.ndarray = field(
        default_factory=lambda: np.zeros(3, np.float32)
    )
    kind: int = MATERIAL_DIFFUSE


def load_mtl(path: str) -> dict[str, Material]:
    materials: dict[str, Material] = {}
    if not os.path.exists(path):
        log.warning("Could not open MTL file: %s", path)
        return materials
    name = None
    cur = Material()
    specular = np.zeros(3, np.float32)
    illum = 2

    def finish():
        if name is None:
            return
        if illum == 5 or (illum >= 3 and specular.max() > 0.5):
            cur.kind = MATERIAL_MIRROR
            cur.albedo = specular.copy()
        materials[name] = cur

    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            key = parts[0]
            if key == "newmtl":
                finish()
                name = parts[1] if len(parts) > 1 else ""
                cur = Material()
                specular = np.zeros(3, np.float32)
                illum = 2
            elif key == "Kd" and len(parts) >= 4:
                cur.albedo = np.array(parts[1:4], np.float32)
            elif key == "Ke" and len(parts) >= 4:
                cur.emission = np.array(parts[1:4], np.float32)
            elif key == "Ks" and len(parts) >= 4:
                specular = np.array(parts[1:4], np.float32)
            elif key == "illum" and len(parts) >= 2:
                try:
                    illum = int(parts[1])
                except ValueError:
                    pass
    finish()
    log.info("Loaded %d materials from %s", len(materials), path)
    return materials


def _parse_face_token(token: str) -> tuple[int, int]:
    """Return (vertex_index, normal_index), 0 when absent. Supports the
    v, v/vt, v//vn, v/vt/vn index forms."""
    fields = token.split("/")
    try:
        v = int(fields[0])
    except ValueError:
        return 0, 0
    vn = 0
    if len(fields) == 3 and fields[2]:
        try:
            vn = int(fields[2])
        except ValueError:
            vn = 0
    return v, vn


def load_obj(path: str, prefer_native: bool = True) -> PrimList:
    """Parse an OBJ file into a host-side primitive list.

    Uses the C++ parser (native/libtpt_native.so) when built — byte-
    identical output, ~20x faster on large files — with this Python
    implementation as the always-available fallback."""
    if prefer_native:
        from ..utils.native import native_load_obj

        try:
            fields = native_load_obj(path)
        except ValueError as e:
            raise ValueError(str(e)) from None
        if fields is not None:
            log.info(
                "Loaded %d primitives from %s (native parser)",
                fields["corners"].shape[0], path,
            )
            return PrimList(**fields)
    return _load_obj_py(path)


def _load_obj_py(path: str) -> PrimList:
    base = os.path.dirname(path)
    vertices: list[np.ndarray] = []
    normals: list[np.ndarray] = []
    materials: dict[str, Material] = {}
    cur = Material()

    out_c, out_q, out_a, out_e, out_m, out_n = [], [], [], [], [], []
    n_tris = n_quads = 0

    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.split("#", 1)[0].strip()  # inline comments too
            if not line or line[0] in "os":
                # comments, object names, smoothing groups: ignored
                # (file_manager.h:120)
                continue
            parts = line.split()
            key = parts[0]
            if key == "v":
                if len(parts) < 4:
                    log.warning("line %d: malformed vertex", lineno)
                    continue
                vertices.append(np.array(parts[1:4], np.float32))
            elif key == "vn":
                if len(parts) < 4:
                    log.warning("line %d: malformed normal", lineno)
                    continue
                n = np.array(parts[1:4], np.float32)
                nl = np.linalg.norm(n)
                normals.append(n / nl if nl > 0 else n)
            elif key == "mtllib" and len(parts) > 1:
                materials = load_mtl(os.path.join(base, parts[1]))
            elif key == "usemtl":
                mname = parts[1] if len(parts) > 1 else ""
                if mname in materials:
                    cur = materials[mname]
                else:
                    log.warning(
                        "Material '%s' not found, using default", mname
                    )
                    cur = Material()
            elif key == "f":
                idx = [_parse_face_token(t) for t in parts[1:]]
                vs = [i[0] for i in idx]
                ns = [i[1] for i in idx]
                if any(
                    v == 0 or v > len(vertices) for v in vs
                ):
                    log.warning("line %d: invalid vertex index", lineno)
                    continue
                pts = [vertices[v - 1] for v in vs]
                face_n = np.zeros(3, np.float32)
                if ns and ns[0] != 0 and ns[0] <= len(normals):
                    face_n = normals[ns[0] - 1]
                if len(pts) == 3:
                    out_c.append(make_triangle_corners(*pts))
                    out_q.append(False)
                    n_tris += 1
                elif len(pts) == 4:
                    out_c.append(np.stack(pts))
                    out_q.append(True)
                    n_quads += 1
                else:
                    log.warning(
                        "line %d: face with %d vertices not supported",
                        lineno, len(pts),
                    )
                    continue
                out_a.append(cur.albedo)
                out_e.append(cur.emission)
                out_m.append(cur.kind)
                out_n.append(face_n)

    if not out_c:
        raise ValueError(f"No valid primitives loaded from {path}")

    log.info(
        "Loaded %d primitives from %s (%d triangles, %d quads)",
        len(out_c), path, n_tris, n_quads,
    )
    return PrimList(
        corners=np.asarray(out_c, np.float32),
        is_quad=np.asarray(out_q, bool),
        albedo=np.asarray(out_a, np.float32),
        emission=np.asarray(out_e, np.float32),
        material=np.asarray(out_m, np.int32),
        normal=np.asarray(out_n, np.float32),
    )
