"""ops/dispatch: one choice of intersection path per platform and scene
size, and every query kind (camera/bounce rays, NEE shadow rays, solver
visibility) routed through it. Also the float contractions that feed
those paths: each states its precision, and integer ids never ride a
float matmul."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pathtracer.ops import dispatch
from pathtracer.ops.bvh import BVH, build_bvh
from pathtracer.ops.intersect import occluded
from pathtracer.ops.intersect_triton import TrianglePack
from pathtracer.render.camera import CameraController
from pathtracer.scene.builtin import cornell_box
from pathtracer.scene.mesh import PrimList, subdivide


class TestSelectBackend:
    @pytest.mark.parametrize("extra, want", [(0, "triton"), (1, "bvh")])
    def test_gpu_by_size(self, extra, want):
        n = dispatch.GPU_KERNEL_MAX_TRIS + extra
        assert dispatch.select_backend("gpu", n) == want

    @pytest.mark.parametrize("extra, want", [(0, "brute"), (1, "bvh")])
    def test_cpu_by_size(self, extra, want):
        n = dispatch.CPU_BRUTE_MAX_TRIS + extra
        assert dispatch.select_backend("cpu", n) == want

    def test_unknown_platform_raises(self):
        with pytest.raises(ValueError, match="no intersection path"):
            dispatch.select_backend("rocm", 32)
        with pytest.raises(ValueError, match="unknown intersection"):
            dispatch.build_accel(cornell_box("quads").build(), "culled")

    def test_current_platform_follows_default_device(self):
        assert dispatch.current_platform() == jax.default_backend()
        with jax.default_device(jax.devices("cpu")[0]):
            assert dispatch.current_platform() == "cpu"

    @pytest.mark.parametrize("platform, sub, want, kind", [
        ("gpu", 0, "triton", TrianglePack),
        ("gpu", 5, "bvh", BVH),
        ("cpu", 0, "brute", type(None)),
        ("cpu", 4, "bvh", BVH),
    ])
    def test_app_selects_by_platform_and_size(self, monkeypatch, platform,
                                              sub, want, kind):
        from pathtracer.app import App
        from pathtracer.utils.config import Config

        monkeypatch.setattr(dispatch, "current_platform", lambda: platform)
        app = App(Config(scene="cbox_quads", subdivision=sub))
        app.load_scene()
        assert app.backend == want
        assert isinstance(app.accel, kind)


def test_guide_rows_only_for_guided_kernel_renders():
    """ProgressiveRenderer repacks the fused kernel's pack with guide rows
    in guided modes only; other accels pass through untouched."""
    from pathtracer.core.constants import SAMPLING_BSDF, SAMPLING_MIS
    from pathtracer.ops.guiding import build_cdfs
    from pathtracer.render.renderer import RenderSettings, with_guide_rows

    geom = cornell_box("quads").build()
    cdfs = build_cdfs(jnp.ones((geom.num_prims, 256)))
    pack = dispatch.build_accel(geom, "triton", interpret=True)
    bvh = build_bvh(geom)
    mis = RenderSettings(sampling_mode=SAMPLING_MIS)
    bsdf = RenderSettings(sampling_mode=SAMPLING_BSDF)
    guided = with_guide_rows(pack, geom, cdfs, mis)
    assert guided.has_guide and guided.interpret
    np.testing.assert_array_equal(np.asarray(guided.attr[:, :16]),
                                  np.asarray(pack.attr))
    assert with_guide_rows(pack, geom, cdfs, bsdf) is pack
    assert with_guide_rows(guided, geom, cdfs, mis) is guided
    assert with_guide_rows(bvh, geom, cdfs, mis) is bvh
    assert with_guide_rows(None, geom, cdfs, mis) is None


def _spy(monkeypatch, name):
    calls = []
    orig = getattr(dispatch, name)

    def spy(*a, **k):
        calls.append(a)
        return orig(*a, **k)

    monkeypatch.setattr(dispatch, name, spy)
    return calls


class TestBVHAnyHitWiring:
    def test_solver_visibility_uses_bvh(self, monkeypatch):
        from pathtracer.render.radiosity import mc_form_factors_rows

        geom = subdivide(cornell_box("quads"), 2).build()
        bvh = build_bvh(geom)
        calls = _spy(monkeypatch, "bvh_occluded")
        k1, k2 = jax.random.split(jax.random.key(0))
        o = jax.random.uniform(k1, (512, 3), minval=-2.5, maxval=2.5) + \
            jnp.array([0.0, 2.75, 0.0])
        d = jax.random.normal(k2, (512, 3))
        d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
        maxd = jnp.full((512,), 3.0)
        ex = jnp.arange(512, dtype=jnp.int32) % geom.num_prims
        got = dispatch.occluded(geom, bvh, o, d, maxd, ex, ex)
        want = occluded(geom, o, d, maxd, ex, ex)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        calls.clear()
        rows = jnp.arange(8, dtype=jnp.int32)
        jax.block_until_ready(mc_form_factors_rows(
            geom, jax.random.key(1), rows, n_samples=2, row_chunk=8,
            accel=bvh,
        ))
        assert calls, "BVH accel must answer solver visibility"

    def test_nee_shadow_rays_use_bvh(self, monkeypatch):
        from pathtracer.render.integrator import trace_wavefront

        geom = cornell_box("quads").build()
        cam = CameraController.default().build()
        calls = _spy(monkeypatch, "bvh_occluded")
        brute = _spy(monkeypatch, "kernel_occluded")
        ids = jnp.arange(256, dtype=jnp.int32)
        x, y = (ids % 16).astype(jnp.float32), (ids // 16).astype(
            jnp.float32)
        total, _, _ = trace_wavefront(
            geom, cam, x, y, jax.random.key(1), width=16, height=16,
            spp=1, max_depth=3, accel=build_bvh(geom), nee=True,
            lane_ids=ids,
        )
        assert calls and not brute
        assert np.isfinite(np.asarray(total)).all()

    def test_nee_render_bvh_matches_brute(self):
        from pathtracer.render.renderer import (
            ProgressiveRenderer,
            RenderSettings,
        )

        geom = subdivide(cornell_box("quads"), 1).build()
        cam = CameraController.default().build()
        s = RenderSettings(width=32, height=32, max_depth=3,
                           spp_per_pass=2, ray_chunk=1024, nee=True)
        films = []
        for accel in (None, build_bvh(geom)):
            r = ProgressiveRenderer(geom, cam, s, seed=3, accel=accel)
            r.step()
            films.append(np.asarray(r.film.accum))
        np.testing.assert_allclose(films[0], films[1], rtol=1e-5,
                                   atol=1e-6)
        assert films[0].max() > 0


# ---------------------------------------------------------------------------
# Precision of the contractions that feed the hit paths
# ---------------------------------------------------------------------------


def _dots(jaxpr):
    """Every dot_general equation of a jaxpr, sub-jaxprs included."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn)
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (list, tuple)) else (v,)):
                if isinstance(sub, jax.extend.core.ClosedJaxpr):
                    out += _dots(sub.jaxpr)
                elif isinstance(sub, jax.extend.core.Jaxpr):
                    out += _dots(sub)
    return out


def _soup_with_far_emitters(n=5000):
    """n small triangles; only primitives with ids above 4,096 emit, so
    their ids need more than a 10-bit mantissa."""
    rng = np.random.default_rng(0)
    a = rng.uniform(-2.0, 2.0, (n, 3))
    corners = np.stack(
        [a, a + [0.05, 0, 0], a + [0, 0.05, 0], a + [0, 0.05, 0]], axis=1
    ).astype(np.float32)
    emission = np.zeros((n, 3), np.float32)
    emit_ids = np.arange(4097, n, 7)
    emission[emit_ids] = rng.uniform(0.5, 2.0, (emit_ids.size, 1))
    return PrimList(
        corners=corners, is_quad=np.zeros(n, bool),
        albedo=np.full((n, 3), 0.5, np.float32), emission=emission,
        material=np.zeros(n, np.int32),
    ).build(), emit_ids


def test_nee_ids_exact_past_2048():
    from pathtracer.render.integrator import build_nee_pack, pick_light

    geom, emit_ids = _soup_with_far_emitters()
    pack = build_nee_pack(geom)
    u = jax.random.uniform(jax.random.key(2), (4096,))
    corners, n_l, le, pdf_a, prim_l = pick_light(pack, u)
    assert prim_l.dtype == jnp.int32
    got = np.asarray(prim_l)
    assert set(got.tolist()) <= set(emit_ids.tolist())
    assert got.min() > 2048 and len(set(got.tolist())) > 50
    # each picked row belongs to the picked primitive
    np.testing.assert_array_equal(
        np.asarray(corners), np.asarray(geom.corners)[got]
    )
    np.testing.assert_array_equal(
        np.asarray(le), np.asarray(geom.emission)[got]
    )


@pytest.mark.parametrize("site", ["nee_pick", "ff_binning", "rebin",
                                  "bvh_transform"])
def test_contraction_precision_stated(site):
    """Each float contraction on these paths runs at HIGHEST precision
    (a DEFAULT f32 dot runs in TF32 on the GPU); the NEE light pick has
    no contraction at all."""
    from pathtracer.ops.bvh import _tri_hit
    from pathtracer.render.integrator import build_nee_pack, pick_light
    from pathtracer.render.radiosity import mc_form_factors_rows, rebin_rows

    geom = cornell_box("quads").build()
    n = geom.num_prims
    if site == "nee_pick":
        pack = build_nee_pack(geom)
        jaxpr = jax.make_jaxpr(lambda u: pick_light(pack, u))(
            jnp.zeros((64,))
        )
    elif site == "ff_binning":
        jaxpr = jax.make_jaxpr(
            lambda k, r: mc_form_factors_rows(geom, k, r, n_samples=2,
                                              row_chunk=4)
        )(jax.random.key(0), jnp.arange(4, dtype=jnp.int32))
    elif site == "rebin":
        jaxpr = jax.make_jaxpr(
            lambda ff, b: rebin_rows(geom, ff, jnp.arange(4), b)
        )(jnp.ones((4, n)), jnp.ones((n, 3)))
    else:
        jaxpr = jax.make_jaxpr(
            lambda t, o, d: _tri_hit(geom, t, o, d)
        )(jnp.zeros((8,), jnp.int32), jnp.zeros((8, 3)), jnp.ones((8, 3)))
    dots = _dots(jaxpr.jaxpr)
    if site == "nee_pick":
        assert dots == []
        return
    assert dots, "expected a contraction"
    for eqn in dots:
        prec = eqn.params["precision"]
        assert prec is not None and all(
            p == jax.lax.Precision.HIGHEST for p in prec
        ), (site, prec)
