"""PBRT loader tests: parser subset, transforms, materials, PLY,
oversize proxy guard."""

import os
import struct

import numpy as np
import pytest

from pathtracer.core.constants import MATERIAL_MIRROR
from pathtracer.scene.pbrt_loader import (
    load_pbrt,
    parse_pbrt,
    read_ply,
)

CBOX_PBRT = """
LookAt 0.5 3 8.5  0 2.5 0  0 1 0
Camera "perspective" "float fov" [40]
Film "rgb" "integer xresolution" [256] "integer yresolution" [256]

WorldBegin

MakeNamedMaterial "white" "string type" "matte" "rgb Kd" [0.8 0.8 0.8]

AttributeBegin
  AreaLightSource "diffuse" "rgb L" [25 25 25]
  NamedMaterial "white"
  Shape "trianglemesh"
    "point3 P" [-0.5 5.4 -3  0.5 5.4 -3  0.5 5.4 -2  -0.5 5.4 -2]
    "integer indices" [0 1 2  0 2 3]
AttributeEnd

Material "matte" "rgb Kd" [0.1 0.8 0.1]
AttributeBegin
  Translate 1 0 0
  Scale 2 2 2
  Shape "trianglemesh"
    "point3 P" [0 0 0  1 0 0  0 1 0]
    "integer indices" [0 1 2]
AttributeEnd

Material "mirror" "rgb Kr" [0.9 0.8 0.7]
Shape "trianglemesh"
  "point3 P" [0 0 -5  1 0 -5  0 1 -5]
  "integer indices" [0 1 2]
  "normal N" [0 0 1  0 0 1  0 0 1]
"""


@pytest.fixture()
def pbrt_file(tmp_path):
    p = tmp_path / "scene.pbrt"
    p.write_text(CBOX_PBRT)
    return str(p)


class TestParser:
    def test_counts_and_camera(self, pbrt_file):
        scene = parse_pbrt(pbrt_file)
        assert scene.prims.num_prims == 4  # 2 light tris + 1 green + 1 mirror
        assert scene.camera_fov == 40
        eye, tgt, up = scene.camera_lookat
        assert eye == (0.5, 3.0, 8.5)
        assert tgt == (0.0, 2.5, 0.0)

    def test_emission_and_materials(self, pbrt_file):
        prims = load_pbrt(pbrt_file)
        np.testing.assert_allclose(prims.emission[0], [25, 25, 25])
        np.testing.assert_allclose(prims.albedo[0], [0.8, 0.8, 0.8])
        np.testing.assert_allclose(prims.albedo[2], [0.1, 0.8, 0.1])
        assert prims.material[3] == MATERIAL_MIRROR
        np.testing.assert_allclose(
            prims.albedo[3], [0.9, 0.8, 0.7], atol=1e-6
        )

    def test_transform_applied(self, pbrt_file):
        prims = load_pbrt(pbrt_file)
        # green triangle: Translate(1,0,0) then Scale(2): p' = 2p + (1,0,0)
        tri = prims.corners[2]
        np.testing.assert_allclose(tri[0], [1, 0, 0], atol=1e-6)
        np.testing.assert_allclose(tri[1], [3, 0, 0], atol=1e-6)
        np.testing.assert_allclose(tri[2], [1, 2, 0], atol=1e-6)

    def test_provided_normals(self, pbrt_file):
        prims = load_pbrt(pbrt_file)
        np.testing.assert_allclose(prims.normal[3], [0, 0, 1], atol=1e-6)

    def test_metal_fresnel(self, tmp_path):
        p = tmp_path / "m.pbrt"
        p.write_text(
            """
WorldBegin
Material "metal" "rgb eta" [2 2 2] "rgb k" [0 0 0]
Shape "trianglemesh" "point3 P" [0 0 0 1 0 0 0 1 0]
  "integer indices" [0 1 2]
"""
        )
        prims = load_pbrt(str(p))
        # R0 = ((n-1)^2)/((n+1)^2) = 1/9
        np.testing.assert_allclose(prims.albedo[0], 1 / 9, rtol=1e-5)

    def test_object_instance(self, tmp_path):
        p = tmp_path / "inst.pbrt"
        p.write_text(
            """
WorldBegin
ObjectBegin "tri"
  Shape "trianglemesh" "point3 P" [0 0 0 1 0 0 0 1 0]
    "integer indices" [0 1 2]
ObjectEnd
AttributeBegin
  Translate 5 0 0
  ObjectInstance "tri"
AttributeEnd
ObjectInstance "tri"
"""
        )
        prims = load_pbrt(str(p))
        assert prims.num_prims == 2
        np.testing.assert_allclose(prims.corners[0][0], [5, 0, 0])
        np.testing.assert_allclose(prims.corners[1][0], [0, 0, 0])

    def test_oversize_proxy(self, pbrt_file):
        scene = parse_pbrt(pbrt_file, max_triangles=2)
        assert scene.is_proxy
        assert scene.prims.num_prims == 12  # bbox proxy
        np.testing.assert_allclose(
            scene.prims.albedo[0], [0.8, 0.2, 0.2]
        )


class TestPly:
    def _write_ascii(self, path):
        path.write_text(
            """ply
format ascii 1.0
element vertex 4
property float x
property float y
property float z
element face 2
property list uchar int vertex_indices
end_header
0 0 0
1 0 0
1 1 0
0 1 0
3 0 1 2
4 0 1 2 3
"""
        )

    def test_ascii(self, tmp_path):
        f = tmp_path / "q.ply"
        self._write_ascii(f)
        v, n, faces = read_ply(str(f))
        assert v.shape == (4, 3)
        assert n is None
        # one triangle + one quad fan-triangulated = 3 tris
        assert faces.shape == (3, 3)

    def test_binary(self, tmp_path):
        f = tmp_path / "b.ply"
        header = (
            b"ply\nformat binary_little_endian 1.0\n"
            b"element vertex 3\n"
            b"property float x\nproperty float y\nproperty float z\n"
            b"element face 1\n"
            b"property list uchar int vertex_indices\n"
            b"end_header\n"
        )
        body = b"".join(
            struct.pack("<fff", *p)
            for p in [(0, 0, 0), (1, 0, 0), (0, 1, 0)]
        ) + struct.pack("<Biii", 3, 0, 1, 2)
        f.write_bytes(header + body)
        v, n, faces = read_ply(str(f))
        assert v.shape == (3, 3)
        np.testing.assert_array_equal(faces, [[0, 1, 2]])

    def test_plymesh_in_pbrt(self, tmp_path):
        self._write_ascii(tmp_path / "mesh.ply")
        p = tmp_path / "s.pbrt"
        p.write_text(
            """
WorldBegin
Material "matte" "rgb Kd" [0.5 0.5 0.5]
Shape "plymesh" "string filename" ["mesh.ply"]
"""
        )
        prims = load_pbrt(str(p))
        assert prims.num_prims == 3


class TestPlyFastPath:
    """The vectorized uniform-arity binary face decoder must agree with
    the per-face loop exactly, and mixed-arity blocks must fall back."""

    @staticmethod
    def _binary_ply(faces):
        header = (
            b"ply\nformat binary_little_endian 1.0\n"
            b"element vertex 6\n"
            b"property float x\nproperty float y\nproperty float z\n"
            b"element face %d\n"
            b"property list uchar int vertex_indices\n"
            b"end_header\n" % len(faces)
        )
        body = b"".join(
            struct.pack("<fff", i, 2 * i, 3 * i) for i in range(6)
        )
        for f in faces:
            body += struct.pack("<B" + "i" * len(f), len(f), *f)
        return header + body

    @staticmethod
    def _fan(faces):
        out = []
        for f in faces:
            for i in range(1, len(f) - 1):
                out.append((f[0], f[i], f[i + 1]))
        return np.asarray(out, np.int32)

    def test_uniform_quads_vectorized(self, tmp_path):
        faces = [(0, 1, 2, 3), (1, 2, 3, 4), (2, 3, 4, 5)]
        f = tmp_path / "u.ply"
        f.write_bytes(self._binary_ply(faces))
        _, _, got = read_ply(str(f))
        np.testing.assert_array_equal(got, self._fan(faces))

    def test_mixed_arity_falls_back(self, tmp_path):
        faces = [(0, 1, 2), (1, 2, 3, 4), (2, 3, 4, 5, 0), (3, 4, 5)]
        f = tmp_path / "m.ply"
        f.write_bytes(self._binary_ply(faces))
        _, _, got = read_ply(str(f))
        np.testing.assert_array_equal(got, self._fan(faces))
