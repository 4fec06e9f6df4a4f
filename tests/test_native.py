"""Native C++ runtime parity tests (skipped when libtpt_native.so is not
built): the ctypes OBJ parser and BVH builder must be byte-identical to
the Python implementations."""

import numpy as np
import pytest

from pathtracer.ops.bvh import LEAF_SIZE, build_bvh
from pathtracer.scene.builtin import cornell_box, write_obj
from pathtracer.scene.mesh import subdivide
from pathtracer.scene.obj_loader import _load_obj_py
from pathtracer.utils.native import (
    get_lib,
    native_build_bvh,
    native_load_obj,
)

pytestmark = pytest.mark.skipif(
    get_lib() is None, reason="native library not built"
)


class TestNativeObj:
    @pytest.mark.parametrize("variant,mirror", [
        ("quads", False), ("tris", False), ("quads", True),
    ])
    def test_parity_with_python(self, tmp_path, variant, mirror):
        path = str(tmp_path / "scene.obj")
        write_obj(cornell_box(variant, mirror_tall_box=mirror), path)
        py = _load_obj_py(path)
        nat = native_load_obj(path)
        assert nat["corners"].shape[0] == py.num_prims
        np.testing.assert_array_equal(nat["corners"], py.corners)
        np.testing.assert_array_equal(nat["is_quad"], py.is_quad)
        np.testing.assert_array_equal(nat["albedo"], py.albedo)
        np.testing.assert_array_equal(nat["emission"], py.emission)
        np.testing.assert_array_equal(nat["material"], py.material)
        np.testing.assert_allclose(nat["normal"], py.normal, atol=1e-7)

    def test_missing_file_raises(self):
        with pytest.raises(ValueError):
            native_load_obj("/nonexistent/file.obj")


class TestNativeBvh:
    def test_parity_with_python(self):
        geom = subdivide(cornell_box("quads"), 2).build()
        py = build_bvh(geom, prefer_native=False)
        v0 = np.asarray(geom.tri_v0)
        v1 = v0 + np.asarray(geom.tri_e1)
        v2 = v0 + np.asarray(geom.tri_e2)
        tmin = np.minimum(np.minimum(v0, v1), v2)
        tmax = np.maximum(np.maximum(v0, v1), v2)
        nat = native_build_bvh(tmin, tmax, LEAF_SIZE)
        assert nat["node_count"].shape[0] == py.num_nodes
        np.testing.assert_array_equal(
            nat["tri_order"], np.asarray(py.tri_order)
        )
        for k in ("node_min", "node_max"):
            np.testing.assert_allclose(
                nat[k], np.asarray(getattr(py, k)), rtol=1e-6
            )
        for k in ("node_left", "node_right", "node_count"):
            np.testing.assert_array_equal(
                nat[k], np.asarray(getattr(py, k))
            )
