"""PBRT scene loader (self-contained text parser + PLY meshes).

Capability parity with `reference/include/utils/pbrt_loader.h`, which
wraps the vendored `ext/pbrtparser` C++ library; here the .pbrt text format
is parsed directly. Supported subset (what the reference path exercises):

  * graphics state: AttributeBegin/End, Transform/ConcatTransform,
    Translate/Scale/Rotate/LookAt, ReverseOrientation (ignored);
  * materials with the reference's down-conversion table
    (pbrt_loader.h:86-164): disney, matte, plastic, metal (Fresnel
    normal-incidence reflectance from eta/k), mirror, glass, substrate,
    uber, translucent -> one RGB via the metallic blend
    diffuse*(1-metallic) + specular*metallic. Divergence (additive):
    "mirror" maps to our MATERIAL_MIRROR specular lobe instead of being
    flattened to diffuse RGB;
  * MakeNamedMaterial / NamedMaterial;
  * AreaLightSource "diffuse" with "rgb/color L" (blackbody approximated);
  * Shape "trianglemesh" (P / indices / optional N — the first vertex's
    normal wins per face, matching pbrt_loader.h:330-334) and
    Shape "plymesh" via a bundled ASCII/binary-LE PLY reader;
  * ObjectBegin/End + ObjectInstance with composed transforms;
  * Include files;
  * the >2M-triangle guard that swaps the scene for a red bounding-box
    proxy (pbrt_loader.h:204-272).

Camera/LookAt/fov are captured and returned so callers can frame the scene
(the reference discards them — additive capability).
"""

from __future__ import annotations

import math
import os
import re
import struct
from dataclasses import dataclass, field

import numpy as np

from ..core.constants import MATERIAL_DIFFUSE, MATERIAL_MIRROR
from ..utils.logger import get_logger
from .mesh import PrimList

log = get_logger("PbrtLoader")

PBRT_MAX_TRIANGLES = 2_000_000  # proxy threshold (pbrt_loader.h:205)


# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(r'"[^"]*"|\[|\]|[^\s"\[\]]+')


def _tokenize(text: str):
    for line in text.splitlines():
        h = line.find("#")
        if h != -1:
            line = line[:h]
        yield from _TOKEN_RE.findall(line)


class _TokenStream:
    def __init__(self, tokens):
        self.toks = list(tokens)
        self.pos = 0

    def peek(self):
        return self.toks[self.pos] if self.pos < len(self.toks) else None

    def next(self):
        t = self.peek()
        self.pos += 1
        return t

    def params(self):
        """Parse '"type name" [values...]' parameter lists until the next
        directive token."""
        out = {}
        while True:
            t = self.peek()
            if t is None or not t.startswith('"'):
                return out
            decl = self.next().strip('"').split()
            if len(decl) == 1:
                # bare string argument (e.g. NamedMaterial "foo") — not a
                # typed parameter; push back and stop
                self.pos -= 1
                return out
            ptype, name = decl[0], decl[1]
            vals = []
            if self.peek() == "[":
                self.next()
                while self.peek() != "]":
                    vals.append(self.next())
                self.next()
            else:
                vals.append(self.next())
            if ptype in ("string", "texture", "bool"):
                out[name] = [v.strip('"') for v in vals]
            elif ptype == "integer":
                out[name] = [int(float(v)) for v in vals]
            else:
                out[name] = [float(v) for v in vals]
        return out


# ---------------------------------------------------------------------------
# Transforms (row-vector affine: p' = p @ M[:3,:3].T + M[:3,3])
# ---------------------------------------------------------------------------


def _identity():
    return np.eye(4, dtype=np.float64)


def _translate(x, y, z):
    m = _identity()
    m[:3, 3] = (x, y, z)
    return m


def _scale(x, y, z):
    m = _identity()
    m[0, 0], m[1, 1], m[2, 2] = x, y, z
    return m


def _rotate(angle_deg, x, y, z):
    a = math.radians(angle_deg)
    axis = np.array([x, y, z], np.float64)
    axis /= max(np.linalg.norm(axis), 1e-20)
    c, s = math.cos(a), math.sin(a)
    ux, uy, uz = axis
    r = np.array(
        [
            [c + ux * ux * (1 - c), ux * uy * (1 - c) - uz * s,
             ux * uz * (1 - c) + uy * s],
            [uy * ux * (1 - c) + uz * s, c + uy * uy * (1 - c),
             uy * uz * (1 - c) - ux * s],
            [uz * ux * (1 - c) - uy * s, uz * uy * (1 - c) + ux * s,
             c + uz * uz * (1 - c)],
        ]
    )
    m = _identity()
    m[:3, :3] = r
    return m


def _apply_pts(m, pts):
    """Affine point transform in float32 — parity with the reference,
    whose transforms run in float Vector3f math (pbrt_loader.h:63-71).
    (Also ~20x faster than NumPy's mixed f32@f64 upcast path: 0.09 s
    vs 1.7-2.7 s on a 2.1M-triangle mesh.)"""
    m32 = np.asarray(m, np.float32)
    return pts @ m32[:3, :3].T + m32[:3, 3]


def _apply_normals(m, nrm):
    """Transform + renormalize via the upper 3x3 (pbrt_loader.h:72-80:
    the reference skips the inverse transpose too); float32 like
    _apply_pts."""
    out = nrm @ np.asarray(m, np.float32)[:3, :3].T
    ln = np.linalg.norm(out, axis=-1, keepdims=True)
    return out / np.maximum(ln, 1e-20)


# ---------------------------------------------------------------------------
# Materials (conversion table parity: pbrt_loader.h:86-164)
# ---------------------------------------------------------------------------


@dataclass
class _Mat:
    albedo: np.ndarray = field(
        default_factory=lambda: np.array([0.8, 0.8, 0.8], np.float32)
    )
    kind: int = MATERIAL_DIFFUSE


def _rgb(params, *names, default=(0.0, 0.0, 0.0)):
    for n in names:
        if n in params:
            v = params[n]
            if len(v) >= 3:
                return np.asarray(v[:3], np.float32)
            if len(v) == 1:
                return np.full(3, v[0], np.float32)
    return np.asarray(default, np.float32)


def _convert_material(mtype: str, params: dict) -> _Mat:
    mtype = mtype.lower()
    if mtype == "disney":
        color = _rgb(params, "color", default=(0.8, 0.8, 0.8))
        metallic = params.get("metallic", [0.0])[0]
        spec = color * metallic
        return _Mat(color * (1 - metallic) + spec * metallic)
    if mtype in ("matte", "", "none"):
        return _Mat(_rgb(params, "Kd", default=(0.8, 0.8, 0.8)))
    if mtype == "plastic":
        return _Mat(_rgb(params, "Kd", default=(0.8, 0.8, 0.8)))
    if mtype == "metal":
        eta = _rgb(params, "eta", default=(0.2, 0.92, 1.1))
        k = _rgb(params, "k", default=(3.9, 2.45, 2.14))
        r = ((eta - 1) ** 2 + k**2) / ((eta + 1) ** 2 + k**2)
        # metallic=1 -> bsdf = specular = r (getBSDF blend)
        return _Mat(r.astype(np.float32))
    if mtype == "mirror":
        kr = _rgb(params, "Kr", default=(0.9, 0.9, 0.9))
        return _Mat(kr, MATERIAL_MIRROR)
    if mtype == "glass":
        return _Mat(_rgb(params, "Kt", default=(1.0, 1.0, 1.0)))
    if mtype in ("substrate", "uber", "translucent"):
        return _Mat(_rgb(params, "Kd", default=(0.8, 0.8, 0.8)))
    log.info("Unknown material type '%s' -> default", mtype)
    return _Mat()


def _blackbody_rgb(temp_k: float, scale: float = 1.0) -> np.ndarray:
    """Crude blackbody -> RGB (the reference defers to pbrtparser's
    LinRGB); adequate for emission tinting."""
    t = temp_k / 100.0
    r = 255.0 if t <= 66 else 329.7 * ((t - 60) ** -0.1332)
    g = (
        99.47 * math.log(t) - 161.12
        if t <= 66
        else 288.12 * ((t - 60) ** -0.0755)
    )
    b = (
        255.0
        if t >= 66
        else (0.0 if t <= 19 else 138.52 * math.log(t - 10) - 305.04)
    )
    rgb = np.clip(np.array([r, g, b]) / 255.0, 0, 1)
    return (rgb * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# PLY reader (for Shape "plymesh")
# ---------------------------------------------------------------------------

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


def read_ply(path: str):
    """Minimal PLY reader: vertex x/y/z (+nx/ny/nz) and face
    vertex_indices; ascii and binary_little_endian formats.

    Returns (vertices (V,3) f32, normals (V,3) f32 or None,
    faces (F,3) i32 — polygons fan-triangulated)."""
    with open(path, "rb") as f:
        data = f.read()
    head_end = data.find(b"end_header")
    if head_end == -1:
        raise ValueError(f"{path}: not a PLY file")
    head_end = data.find(b"\n", head_end) + 1
    header = data[:head_end].decode("ascii", "replace")
    body = data[head_end:]

    fmt = "ascii"
    elements = []  # (name, count, [(prop, type, is_list, idx_type)])
    for line in header.splitlines():
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property" and elements:
            if parts[1] == "list":
                elements[-1][2].append(
                    (parts[4], parts[3], True, parts[2])
                )
            else:
                elements[-1][2].append((parts[2], parts[1], False, None))

    verts = norms = None
    faces = []
    faces_arr = None  # set by the vectorized uniform-arity path
    if fmt == "ascii":
        tokens = body.decode("ascii", "replace").split()
        pos = 0
        for name, count, props in elements:
            if name == "vertex":
                width = len(props)
                arr = np.array(
                    tokens[pos : pos + count * width], np.float64
                ).reshape(count, width)
                pos += count * width
                cols = {p[0]: i for i, p in enumerate(props)}
                verts = arr[:, [cols["x"], cols["y"], cols["z"]]]
                if "nx" in cols:
                    norms = arr[:, [cols["nx"], cols["ny"], cols["nz"]]]
            elif name == "face":
                for _ in range(count):
                    k = int(tokens[pos]); pos += 1
                    idx = [int(tokens[pos + i]) for i in range(k)]
                    pos += k
                    for i in range(1, k - 1):
                        faces.append((idx[0], idx[i], idx[i + 1]))
            else:
                # skip unknown ascii elements conservatively
                for _ in range(count):
                    pos += len(props)
    elif fmt == "binary_little_endian":
        off = 0
        for name, count, props in elements:
            if name == "vertex" and all(not p[2] for p in props):
                np_dtype = np.dtype(
                    [
                        (f"f{i}", "<" + _PLY_TYPES[p[1]][0])
                        for i, p in enumerate(props)
                    ]
                )
                width = np_dtype.itemsize
                arr = np.frombuffer(
                    body, dtype=np_dtype, count=count, offset=off
                )
                off += count * width
                cols = {p[0]: f"f{i}" for i, p in enumerate(props)}
                verts = np.stack(
                    [arr[cols[c]] for c in ("x", "y", "z")], axis=-1
                ).astype(np.float32)
                if "nx" in cols:
                    norms = np.stack(
                        [arr[cols[c]] for c in ("nx", "ny", "nz")], axis=-1
                    ).astype(np.float32)
            elif name == "face":
                cnt_t, cnt_w = _PLY_TYPES[props[0][3]]
                idx_t, idx_w = _PLY_TYPES[props[0][1]]
                # Uniform-arity fast path (the overwhelmingly common
                # case): peek the first face's count; if every record
                # in a fixed-stride structured view carries that count,
                # the parse is provably correct (the first deviating
                # face would sit at the right offset and fail the
                # check), and the whole block decodes vectorized —
                # the per-face struct.unpack loop cost 6 s at 2.1M.
                done = False
                if count > 0:
                    (k0,) = struct.unpack_from("<" + cnt_t, body, off)
                    if k0 >= 3:
                        rec = np.dtype([("n", "<" + cnt_t),
                                        ("i", "<" + idx_t, (k0,))])
                        need = count * rec.itemsize
                        if len(body) - off >= need:
                            arr = np.frombuffer(
                                body, dtype=rec, count=count, offset=off
                            )
                            if (arr["n"] == k0).all():
                                idx = arr["i"]
                                # fan triangulation, face-major — the
                                # same order the serial loop appends
                                fan = np.stack(
                                    [
                                        np.broadcast_to(
                                            idx[:, :1],
                                            (count, k0 - 2),
                                        ),
                                        idx[:, 1:-1],
                                        idx[:, 2:],
                                    ],
                                    axis=-1,
                                ).reshape(-1, 3)
                                faces_arr = fan.astype(np.int32)
                                off += need
                                done = True
                if not done:
                    for _ in range(count):
                        (k,) = struct.unpack_from("<" + cnt_t, body, off)
                        off += cnt_w
                        idx = struct.unpack_from(
                            "<" + idx_t * k, body, off
                        )
                        off += idx_w * k
                        for i in range(1, k - 1):
                            faces.append((idx[0], idx[i], idx[i + 1]))
            else:
                raise ValueError(
                    f"{path}: unsupported PLY element '{name}'"
                )
    else:
        raise ValueError(f"{path}: unsupported PLY format {fmt}")

    if faces_arr is None and faces:
        faces_arr = np.asarray(faces, np.int32)
    if verts is None or faces_arr is None or not len(faces_arr):
        raise ValueError(f"{path}: no vertex/face data")
    return (
        verts.astype(np.float32, copy=False),
        None if norms is None else norms.astype(np.float32, copy=False),
        faces_arr,
    )


# ---------------------------------------------------------------------------
# Scene interpreter
# ---------------------------------------------------------------------------


@dataclass
class _GState:
    ctm: np.ndarray = field(default_factory=_identity)
    material: _Mat = field(default_factory=_Mat)
    emission: np.ndarray = field(
        default_factory=lambda: np.zeros(3, np.float32)
    )

    def copy(self):
        return _GState(
            self.ctm.copy(), _Mat(self.material.albedo.copy(),
                                  self.material.kind),
            self.emission.copy(),
        )


@dataclass
class PbrtScene:
    prims: PrimList
    camera_lookat: tuple | None = None   # (eye, target, up)
    camera_fov: float | None = None
    is_proxy: bool = False


def load_pbrt(path: str, max_triangles: int = PBRT_MAX_TRIANGLES):
    """Parse a .pbrt file into a PrimList (loadPBRT parity)."""
    scene = parse_pbrt(path, max_triangles)
    return scene.prims


def parse_pbrt(path: str, max_triangles: int = PBRT_MAX_TRIANGLES):
    base = os.path.dirname(path)
    with open(path) as f:
        text = f.read()

    ts = _TokenStream(_tokenize(text))
    gs = _GState()
    stack: list[_GState] = []
    named: dict[str, _Mat] = {}
    objects: dict[str, list] = {}
    cur_object: str | None = None
    cam_lookat = None
    cam_fov = None

    # collected meshes: list of (verts(V,3), faces(F,3),
    # vnorms(V,3)|None, mat, emission) — vertices stay UN-gathered so
    # the transform runs over V points, not 3F (identical f32 results:
    # per-vertex arithmetic is the same either side of the gather)
    meshes = []
    total_tris = 0

    def add_mesh(verts, faces, vnorms, state):
        nonlocal total_tris
        rec = (verts, faces, vnorms, state.material,
               state.emission.copy())
        if cur_object is not None:
            objects[cur_object].append((state.ctm.copy(), rec))
        else:
            meshes.append((state.ctm.copy(), rec))
            total_tris += len(faces)

    def handle_include(fname):
        nonlocal ts
        sub = os.path.join(base, fname)
        with open(sub) as f:
            sub_toks = list(_tokenize(f.read()))
        ts.toks[ts.pos : ts.pos] = sub_toks

    while True:
        tok = ts.next()
        if tok is None:
            break
        if tok == "Include":
            handle_include(ts.next().strip('"'))
        elif tok == "LookAt":
            vals = [float(ts.next()) for _ in range(9)]
            cam_lookat = (
                tuple(vals[0:3]), tuple(vals[3:6]), tuple(vals[6:9])
            )
        elif tok == "Camera":
            ctype = ts.next().strip('"')
            params = ts.params()
            if "fov" in params:
                cam_fov = float(params["fov"][0])
        elif tok in ("Integrator", "Sampler", "Film", "Filter",
                     "PixelFilter", "Accelerator", "ColorSpace"):
            ts.next()        # quoted type
            ts.params()
        elif tok == "WorldBegin":
            gs = _GState()
            stack.clear()
        elif tok in ("WorldEnd",):
            pass
        elif tok in ("AttributeBegin", "TransformBegin"):
            stack.append(gs.copy())
        elif tok in ("AttributeEnd", "TransformEnd"):
            if stack:
                gs = stack.pop()
        elif tok == "Transform":
            vals = _read_bracket_floats(ts, 16)
            gs.ctm = np.asarray(vals, np.float64).reshape(4, 4).T
        elif tok == "ConcatTransform":
            vals = _read_bracket_floats(ts, 16)
            m = np.asarray(vals, np.float64).reshape(4, 4).T
            gs.ctm = gs.ctm @ m
        elif tok == "Translate":
            gs.ctm = gs.ctm @ _translate(
                *(float(ts.next()) for _ in range(3))
            )
        elif tok == "Scale":
            gs.ctm = gs.ctm @ _scale(
                *(float(ts.next()) for _ in range(3))
            )
        elif tok == "Rotate":
            gs.ctm = gs.ctm @ _rotate(
                *(float(ts.next()) for _ in range(4))
            )
        elif tok == "ReverseOrientation":
            pass
        elif tok == "Material":
            mtype = ts.next().strip('"')
            gs.material = _convert_material(mtype, ts.params())
        elif tok == "MakeNamedMaterial":
            name = ts.next().strip('"')
            params = ts.params()
            mtype = params.get("type", ["matte"])[0]
            named[name] = _convert_material(mtype, params)
        elif tok == "NamedMaterial":
            name = ts.next().strip('"')
            gs.material = named.get(name, _Mat())
            if name not in named:
                log.warning("NamedMaterial '%s' not found", name)
        elif tok == "AreaLightSource":
            ltype = ts.next().strip('"')
            params = ts.params()
            if "L" in params:
                vals = params["L"]
                if len(vals) >= 3:
                    gs.emission = np.asarray(vals[:3], np.float32)
                else:
                    gs.emission = _blackbody_rgb(float(vals[0]))
            else:
                gs.emission = np.ones(3, np.float32)
            scale = params.get("scale", [1.0])
            gs.emission = gs.emission * np.float32(scale[0])
        elif tok == "Texture":
            ts.next()
            ts.next()
            ts.next()
            ts.params()
        elif tok == "ObjectBegin":
            cur_object = ts.next().strip('"')
            objects[cur_object] = []
            stack.append(gs.copy())
        elif tok == "ObjectEnd":
            cur_object = None
            if stack:
                gs = stack.pop()
        elif tok == "ObjectInstance":
            name = ts.next().strip('"')
            for def_ctm, rec in objects.get(name, []):
                meshes.append((gs.ctm @ def_ctm, rec))
                total_tris += len(rec[1])
        elif tok == "Shape":
            stype = ts.next().strip('"')
            params = ts.params()
            if stype == "trianglemesh":
                pts = params.get("P", [])
                idx = params.get("indices", [])
                verts = np.asarray(pts, np.float32).reshape(-1, 3)
                faces = np.asarray(idx, np.int32).reshape(-1, 3)
                vnorms = None
                if "N" in params:
                    nn = np.asarray(params["N"], np.float32).reshape(-1, 3)
                    if len(nn) >= len(verts):
                        vnorms = nn
                add_mesh(verts, faces, vnorms, gs)
            elif stype == "plymesh":
                fname = params.get("filename", [""])[0]
                try:
                    verts, vnorms, faces = read_ply(
                        os.path.join(base, fname)
                    )
                    add_mesh(verts, faces, vnorms, gs)
                except Exception as e:  # noqa: BLE001
                    log.warning("plymesh '%s' failed: %s", fname, e)
            else:
                log.info("Skipping non-triangle shape: %s", stype)
        elif tok in ("LightSource", "MediumInterface", "MakeNamedMedium"):
            ts.next()
            ts.params()
        else:
            log.debug("Ignoring directive: %s", tok)

    # ----- size guard -> bbox proxy (pbrt_loader.h:227-272) -----
    if total_tris > max_triangles:
        log.warning(
            "PBRT scene too large (%d triangles) — bounding-box proxy",
            total_tris,
        )
        lo = np.full(3, np.inf)
        hi = np.full(3, -np.inf)
        for ctm, (verts, faces, _, _, _) in meshes:
            # bbox over USED vertices only (matches the pre-gather
            # behavior exactly; stray unreferenced verts don't count)
            p = _apply_pts(ctm, verts)[np.unique(faces)]
            lo = np.minimum(lo, p.min(0))
            hi = np.maximum(hi, p.max(0))
        prims = _bbox_proxy(lo, hi)
        return PbrtScene(prims, cam_lookat, cam_fov, is_proxy=True)

    # ----- expand -----
    corners, albedo, emission, material, normals = [], [], [], [], []
    for ctm, (verts, faces, vnorms, mat, emit) in meshes:
        f = faces.shape[0]
        p = _apply_pts(ctm, verts)[faces]            # (F, 3, 3)
        c = np.concatenate([p, p[:, 2:3]], axis=1)   # (F, 4, 3) tri enc
        corners.append(c.astype(np.float32, copy=False))
        if vnorms is not None:
            # first-vertex normal wins (pre-gather parity)
            fn = _apply_normals(ctm, vnorms)[faces[:, 0]]
            normals.append(fn.astype(np.float32, copy=False))
        else:
            normals.append(np.zeros((f, 3), np.float32))
        albedo.append(np.broadcast_to(mat.albedo, (f, 3)))
        emission.append(np.broadcast_to(emit, (f, 3)))
        material.append(np.full(f, mat.kind, np.int32))

    if not corners:
        raise ValueError(f"No triangles found in PBRT scene {path}")

    n = sum(c.shape[0] for c in corners)
    prims = PrimList(
        corners=np.concatenate(corners),
        is_quad=np.zeros(n, bool),
        albedo=np.concatenate(albedo).astype(np.float32),
        emission=np.concatenate(emission).astype(np.float32),
        material=np.concatenate(material),
        normal=np.concatenate(normals),
    )
    log.info(
        "PBRT scene loaded: %d meshes, %d triangles", len(meshes), n
    )
    return PbrtScene(prims, cam_lookat, cam_fov)


def _read_bracket_floats(ts, n):
    vals = []
    if ts.peek() == "[":
        ts.next()
        while ts.peek() != "]":
            vals.append(float(ts.next()))
        ts.next()
    else:
        vals = [float(ts.next()) for _ in range(n)]
    return vals


def _bbox_proxy(lo, hi) -> PrimList:
    """12-triangle red box proxy (pbrt_loader.h:229-262)."""
    corners8 = np.array(
        [
            [lo[0], lo[1], lo[2]], [lo[0], lo[1], hi[2]],
            [lo[0], hi[1], lo[2]], [lo[0], hi[1], hi[2]],
            [hi[0], lo[1], lo[2]], [hi[0], lo[1], hi[2]],
            [hi[0], hi[1], lo[2]], [hi[0], hi[1], hi[2]],
        ],
        np.float32,
    )
    quads = [
        (0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1),
        (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3),
    ]
    tris = []
    for a, b, c, d in quads:
        tris.append((corners8[a], corners8[b], corners8[c]))
        tris.append((corners8[a], corners8[c], corners8[d]))
    n = len(tris)
    corners = np.stack(
        [np.stack([a, b, c, c]) for a, b, c in tris]
    )
    return PrimList(
        corners=corners,
        is_quad=np.zeros(n, bool),
        albedo=np.broadcast_to(
            np.array([0.8, 0.2, 0.2], np.float32), (n, 3)
        ).copy(),
        emission=np.zeros((n, 3), np.float32),
        material=np.zeros(n, np.int32),
        normal=np.zeros((n, 3), np.float32),
    )
