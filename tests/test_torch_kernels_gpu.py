"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Without a CUDA device every test here skips.  The file imports no
JAX, so that it also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Forward tolerance (tests/test_megakernel.py::_compare): at most 0.5% of
pixels differ by more than 1e-3, more than 99% agree within 1e-4, and the
means within 2e-3.  The kernel rounds as the plain version does (see the
note in csrc/megakernel.cu), so a pixel moves only where fmaf and the
plain version's fma rounded through float64 differ by an ulp across a
discrete event.

Backward tolerance (tests/test_megagrad.py): per scene leaf,
max|a - b| / max|b| under 5e-3 (reference spheres), 1e-3 (constant sky),
8e-2 and a cosine above 0.9999 (README: fuzzy-metal chains are
ill-conditioned in f32), 5e-3 (emissive clamp), 2e-2 (40 random spheres).
The kernel's per-block sums of the sphere cotangents go through atomics
in an order that changes from run to run; its camera cotangents are
summed in a fixed order (each thread's in the order of its work items,
then the threads of a block in turn), so two launches give them equal.
The mesh backward (tests/test_megagrad.py's mesh tests): 5e-4 per leaf,
focus_dist at the reference scene's 5e-3,
1e-4 on the camera without spheres; its triangle cotangents also go
through atomics.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import opencl_ray_tracer_tpu_torch as ot
from opencl_ray_tracer_tpu_torch.kernels import megagrad as mg
from opencl_ray_tracer_tpu_torch.kernels import megakernel as mk
from opencl_ray_tracer_tpu_torch.scene import scene_to_numpy

torch.set_num_threads(1)


def _scenes():
    readme = ot.readme_scene()
    const = ot.Scene(readme.camera, readme.spheres, readme.triangles,
                     readme.boxes, ot.Sky.constant((0.2, 0.4, 0.6)))
    return {"readme": (readme, {}),
            "reference_spheres": (ot.reference_scene(), {}),
            "const_sky": (const, {}),
            "nan_zero_no_clamp": (readme, dict(nan_policy="zero",
                                               clamp_samples=False)),
            "book_cover": (ot.book_cover_scene(), {})}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(_scenes()))
def test_kernel_matches_plain_on_card(cuda, case):
    scene, kw = _scenes()[case]
    scene = scene.to(cuda)
    # 50x30 pixels: not a multiple of the 128-thread block
    cfg = ot.RenderConfig(width=50, height=30, spp=4, max_depth=6, **kw)
    before = mk.LAUNCHES
    got = ot.render(scene, cfg, seed=3)
    torch.cuda.synchronize()
    assert mk.LAUNCHES == before + 1
    r, g, b = mk.render_spheres_plain(
        mk.camera_table(scene), mk.sphere_table(scene), scene.spheres.count,
        cfg, scene.sky.kind, mk.specialize_flags(scene), 3,
        cfg.width * cfg.height)
    want = torch.stack([r, g, b], -1).reshape(got.shape)
    diff = (got - want).abs()
    assert (diff > 1e-3).float().mean() < 0.005
    assert (diff <= 1e-4).float().mean() > 0.99
    assert abs(float(got.mean() - want.mean())) < 2e-3


@pytest.mark.gpu
def test_kernel_pixel_window_and_bounces(cuda):
    """pix_offset/sample_base select a pixel and sample window; the
    bounce counter agrees with the plain version's."""
    scene = ot.reference_scene().to(cuda)
    cfg = ot.RenderConfig(width=40, height=20, spp=3, max_depth=5)
    args = (mk.camera_table(scene), mk.sphere_table(scene),
            scene.spheres.count, cfg, scene.sky.kind,
            mk.specialize_flags(scene), 11, 300)
    kb = torch.zeros(1, dtype=torch.int64, device=cuda)
    pb = torch.zeros(1, dtype=torch.int64, device=cuda)
    got = torch.stack(mk.render_spheres(*args, pix_offset=170, sample_base=5,
                                        bounces=kb), -1)
    want = torch.stack(mk.render_spheres_plain(*args, pix_offset=170,
                                               sample_base=5, bounces=pb), -1)
    torch.cuda.synchronize()
    assert (got - want).abs().max() < 1e-3
    assert abs(kb.item() - pb.item()) <= 0.001 * pb.item() + 2


def random_spheres(n: int, seed: int = 42):
    """n random Lambertian and metal spheres with the reference camera."""
    rng = np.random.default_rng(seed)
    base = ot.reference_scene()

    def f32(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32)

    return dataclasses.replace(base, spheres=ot.Spheres(
        center=f32(np.stack([rng.uniform(-3, 3, n), rng.uniform(0.3, 0.8, n),
                             rng.uniform(-3, 3, n)], 1)),
        radius=f32(rng.uniform(0.2, 0.45, n)),
        albedo=f32(rng.uniform(0.1, 0.9, (n, 3))),
        fuzz=f32(rng.uniform(0.0, 0.3, n)), ior=f32(np.full(n, 1.5)),
        mat_type=torch.tensor(rng.integers(0, 2, n), dtype=torch.int32)))


def _grad_scenes():
    ref = ot.reference_scene()
    alb = ref.spheres.albedo.clone()
    alb[5] = torch.tensor([2.5, 0.9, 2.5])  # the emissive sphere
    return {
        "readme": (ot.readme_scene(), 8e-2),
        "reference_spheres": (ref, 5e-3),
        "const_sky": (dataclasses.replace(
            ref, sky=ot.Sky.constant((0.6, 0.7, 0.9))), 1e-3),
        "emissive_clamp": (dataclasses.replace(
            ref, spheres=dataclasses.replace(ref.spheres, albedo=alb)), 5e-3),
        "random_40": (random_spheres(40), 2e-2),
    }


GRAD_LEAVES = ("spheres.center", "spheres.radius", "spheres.albedo",
               "spheres.fuzz", "spheres.ior", "camera.look_from",
               "camera.look_at", "camera.vfov_deg", "camera.aperture_deg",
               "camera.focus_dist", "sky.const_colour")


def leaf_errors(got, want) -> dict:
    """max|a - b| / max|b| per leaf (scale floor 1e-6)."""
    a, b = scene_to_numpy(got), scene_to_numpy(want)
    return {k: float(np.abs(a[k] - b[k]).max())
            / max(float(np.abs(b[k]).max()), 1e-6) for k in GRAD_LEAVES}


def check_grad_case(cuda, case, cfg, seed):
    """The kernel's scene gradient (one launch) against its plain
    version's for _grad_scenes()[case] at cfg, under the case's tolerance
    (README: also a cosine above 0.9999)."""
    scene, rtol = _grad_scenes()[case]
    scene = scene.to(cuda)
    img = ot.render(scene, cfg, seed=seed)
    g_img = (2.0 / img.numel()) * img
    before = mg.LAUNCHES
    got = mg.render_grad_scene(scene, cfg, g_img, seed=seed)
    torch.cuda.synchronize()
    assert mg.LAUNCHES == before + 1
    g = (g_img.reshape(-1, 3) / cfg.spp).T.contiguous()
    gcam, gsph = mg.render_grad_tables_plain(
        mk.camera_table(scene), mk.sphere_table(scene), scene.spheres.count,
        cfg, scene.sky.kind, mk.specialize_flags(scene), g[0], g[1], g[2],
        seed, cfg.width * cfg.height)
    want = mg.table_grads_to_scene(scene, gcam, gsph)
    errs = leaf_errors(got, want)
    assert max(errs.values()) < rtol, errs
    if case == "readme":
        keys = ("spheres.center", "spheres.albedo", "spheres.radius")
        a, b = scene_to_numpy(got), scene_to_numpy(want)
        va = np.concatenate([a[k].ravel() for k in keys])
        vb = np.concatenate([b[k].ravel() for k in keys])
        assert va @ vb / (np.linalg.norm(va) * np.linalg.norm(vb)) > 0.9999


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(_grad_scenes()))
def test_grad_kernel_matches_plain_on_card(cuda, case):
    check_grad_case(cuda, case, ot.RenderConfig(
        width=50, height=30, spp=4, max_depth=6, nan_policy="zero"), seed=3)


@pytest.mark.gpu
def test_grad_kernel_strides_over_pixels(cuda):
    """More work items (pixel samples) than the kernel's resident threads:
    each thread takes several items of several pixels, reusing its records
    and carrying its camera cotangents from one to the next; the result
    still matches the plain version (README tolerance)."""
    scene = ot.readme_scene().to(cuda)
    cfg = ot.RenderConfig(width=400, height=200, spp=4, max_depth=6,
                          nan_policy="zero")
    n_pix = cfg.width * cfg.height
    n_items = n_pix * cfg.spp
    threads = mg._library().sphere_megagrad_threads(n_items,
                                                    scene.spheres.count)
    assert 0 < threads < n_items
    img = ot.render(scene, cfg, seed=3)
    g_img = (2.0 / img.numel()) * img
    got = mg.render_grad_scene(scene, cfg, g_img, seed=3)
    g = (g_img.reshape(-1, 3) / cfg.spp).T.contiguous()
    gcam, gsph = mg.render_grad_tables_plain(
        mk.camera_table(scene), mk.sphere_table(scene), scene.spheres.count,
        cfg, scene.sky.kind, mk.specialize_flags(scene), g[0], g[1], g[2], 3,
        n_pix)
    errs = leaf_errors(got, mg.table_grads_to_scene(scene, gcam, gsph))
    assert max(errs.values()) < 8e-2, errs


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["readme", "reference_spheres"])
def test_grad_kernel_depth_50_matches_plain_on_card(cuda, case):
    """At the main path's depth, where lanes' paths end far apart (the
    README's fuzzy metal, the reference scene's glass)."""
    check_grad_case(cuda, case, ot.RenderConfig(
        width=64, height=36, spp=4, max_depth=50, nan_policy="zero"), seed=5)


@pytest.mark.gpu
def test_grad_kernel_camera_cotangents_repeat(cuda):
    """Two launches on the same inputs give equal camera cotangents (a
    pinhole's focus-distance gradient is zero up to rounding, so its
    rounding must not change from run to run), with several items per
    thread."""
    scene = ot.readme_scene().to(cuda)
    cfg = ot.RenderConfig(width=400, height=200, spp=4, max_depth=50,
                          nan_policy="zero")
    n_pix = cfg.width * cfg.height
    cam, sph = mk.camera_table(scene), mk.sphere_table(scene)
    img = ot.render(scene, cfg, seed=3)
    g = ((2.0 / img.numel() / cfg.spp) * img).reshape(-1, 3).T.contiguous()
    args = (cam, sph, scene.spheres.count, cfg, scene.sky.kind,
            mk.specialize_flags(scene), g[0], g[1], g[2], 3, n_pix)
    first, _ = mg.render_grad_tables(*args)
    second, _ = mg.render_grad_tables(*args)
    assert torch.equal(first, second)
    assert first.abs().max() > 0


@pytest.mark.gpu
def test_grad_sampled_runs_both_kernels(cuda):
    cfg = ot.RenderConfig(width=40, height=24, spp=3, max_depth=5)
    k1, k4 = mk.LAUNCHES, mg.LAUNCHES
    loss, img, grads = ot.render_grad_sampled(
        ot.readme_scene(), cfg, lambda im: torch.mean(im ** 2), seed=2)
    torch.cuda.synchronize()
    assert (mk.LAUNCHES, mg.LAUNCHES) == (k1 + 1, k4 + 1)
    assert img.device.type == "cuda" and torch.isfinite(loss)
    assert torch.isfinite(grads.spheres.center).all()
    assert grads.spheres.albedo.abs().max() > 0


@pytest.mark.gpu
def test_failing_grad_launch_raises(cuda, monkeypatch):
    class Failing:
        def sphere_megagrad_threads(self, n_items, n_spheres):
            return 128

        def sphere_megagrad_launch(self, *args):
            return 700

    monkeypatch.setattr(mg, "_library", lambda: Failing())
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        ot.render_grad_sampled(ot.readme_scene(),
                               ot.RenderConfig(width=8, height=4, spp=1,
                                               max_depth=2),
                               lambda im: im.mean())


def mesh_scenes():
    """The mesh cases of chip_smoke.py: the tests/test_megamesh.py scene
    (a 192-triangle fuzzy-metal torus with the reference spheres), under a
    constant sky, as a dielectric and as an emitter, and behind the camera
    (its box is never in view)."""
    from opencl_ray_tracer_tpu_torch.io import parse_obj
    from opencl_ray_tracer_tpu_torch.io.procgen import make_torus_obj
    from opencl_ray_tracer_tpu_torch.scene import materials as mat

    def torus(translate=(0.3, 0.0, -1.6), sky=None, **material):
        tris, aabb = parse_obj(make_torus_obj(12, 8), scale=(0.5, 0.5, 0.5),
                               translate=translate)
        scene = ot.reference_scene(mesh_tris=tris, mesh_aabb=aabb, sky=sky)
        t = scene.triangles
        fields = {k: (torch.tensor(v).expand(t.count, 3).clone()
                      if k == "albedo" else torch.full_like(getattr(t, k), v))
                  for k, v in material.items()}
        return dataclasses.replace(
            scene, triangles=dataclasses.replace(t, **fields))

    return {"mesh": torus(),
            "many_boxes": split_boxes(torus()),
            "const_sky": torus(sky=ot.Sky.constant((0.2, 0.4, 0.6))),
            "dielectric": torus(mat_type=mat.DIELECTRIC, ior=1.5),
            "emissive": torus(mat_type=mat.EMISSIVE, albedo=(2.0, 1.5, 1.0)),
            "hidden_box": torus(translate=(-3.0, 0.2, 4.0))}


def split_boxes(scene, n_boxes=40):
    """Triangle i in gating box i % n_boxes, each box the bounds of its
    triangles and every third moved away (its triangles never drawn): more
    boxes than a 32-bit mask holds."""
    t = scene.triangles
    bid = torch.arange(t.count, dtype=torch.int32) % n_boxes
    pts = torch.stack([t.p0, t.p1, t.p2], 1)
    lo = torch.stack([pts[bid == b].reshape(-1, 3).amin(0)
                      for b in range(n_boxes)])
    hi = torch.stack([pts[bid == b].reshape(-1, 3).amax(0)
                      for b in range(n_boxes)])
    away = (torch.arange(n_boxes) % 3 == 0)[:, None] * 50.0
    return dataclasses.replace(
        scene, triangles=dataclasses.replace(t, box_id=bid),
        boxes=ot.BoundingBoxes(lo + away, hi + away))


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(mesh_scenes()))
def test_mesh_kernel_matches_plain_on_card(cuda, case):
    from opencl_ray_tracer_tpu_torch.kernels import megamesh as mm
    scene = mesh_scenes()[case].to(cuda)
    cfg = ot.RenderConfig(width=50, height=30, spp=4, max_depth=6)
    before = mm.LAUNCHES
    got = ot.render(scene, cfg, seed=3)
    torch.cuda.synchronize()
    assert mm.LAUNCHES == before + 1
    r, g, b = mm.render_mesh_plain(
        mm.mesh_camera_table(scene), mk.sphere_table(scene),
        scene.spheres.count, mm.mesh_tables(scene), cfg, scene.sky.kind,
        mm.specialize_mesh_flags(scene), 3, cfg.width * cfg.height)
    want = torch.stack([r, g, b], -1).reshape(got.shape)
    diff = (got - want).abs()
    assert (diff > 1e-3).float().mean() < 0.005
    assert (diff <= 1e-4).float().mean() > 0.99
    assert abs(float(got.mean() - want.mean())) < 2e-3


@pytest.mark.gpu
def test_mesh_kernel_pixel_window_and_counts(cuda):
    """pix_offset/sample_base select a pixel and sample window; the bounce
    count equals the plain version's, and the kernel runs no more triangle
    tests than the plain fold (it also culls by entry t and sub-box)."""
    from opencl_ray_tracer_tpu_torch.kernels import megamesh as mm
    scene = mesh_scenes()["mesh"].to(cuda)
    cfg = ot.RenderConfig(width=40, height=20, spp=3, max_depth=5)
    args = (mm.mesh_camera_table(scene), mk.sphere_table(scene),
            scene.spheres.count, mm.mesh_tables(scene), cfg, scene.sky.kind,
            mm.specialize_mesh_flags(scene), 11, 300)
    kc = torch.zeros(2, dtype=torch.int64, device=cuda)
    pc = torch.zeros(2, dtype=torch.int64, device=cuda)
    got = torch.stack(mm.render_mesh(*args, pix_offset=170, sample_base=5,
                                     counts=kc), -1)
    want = torch.stack(mm.render_mesh_plain(*args, pix_offset=170,
                                            sample_base=5, counts=pc), -1)
    torch.cuda.synchronize()
    assert (got - want).abs().max() < 1e-3
    assert abs(kc[0].item() - pc[0].item()) <= 0.001 * pc[0].item() + 2
    assert 0 < kc[1].item() <= pc[1].item()


@pytest.mark.gpu
@pytest.mark.parametrize("n_rays", [4099, 65536])
def test_closest_tri_matches_plain_on_card(cuda, n_rays):
    """Rays from around a 2,304-triangle torus towards points in its box
    (n_rays not a multiple of the 128-thread block, and a batch of 512
    blocks): indices equal on all but 1e-4 of the rays, t within 1e-6
    relative where they agree."""
    from opencl_ray_tracer_tpu_torch.io import parse_obj
    from opencl_ray_tracer_tpu_torch.io.procgen import make_torus_obj
    from opencl_ray_tracer_tpu_torch.kernels import intersect_mm as im
    tris, aabb = parse_obj(make_torus_obj(48, 24))
    scene = ot.reference_scene(mesh_tris=tris, mesh_aabb=aabb).to(cuda)
    tab = im.mesh_tables(scene)
    rng = np.random.default_rng(5)
    o = rng.normal(0.0, 2.0, (n_rays, 3)).astype(np.float32)
    target = rng.uniform(aabb[0], aabb[1], (n_rays, 3)).astype(np.float32)
    o = torch.tensor(o, device=cuda)
    d = torch.tensor(target, device=cuda) - o
    before = im.LAUNCHES
    t, idx = im.closest_tri(tab, o, d, 1e-3)
    torch.cuda.synchronize()
    assert im.LAUNCHES == before + 1
    tp, ip = im.closest_tri_plain(tab, o, d, 1e-3)
    hit = tp < 1e38
    assert hit.float().mean() > 0.3
    same = idx == ip
    assert same.float().mean() >= 0.9999
    rel = ((t - tp).abs() / tp.abs().clamp(min=1e-30))[same & hit]
    assert rel.max() <= 1e-6


@pytest.mark.gpu
def test_closest_tri_many_boxes_on_card(cuda):
    """A 2,304-triangle torus over 40 gating boxes: the kernel tests each
    chunk's own box, and agrees with its plain version."""
    from opencl_ray_tracer_tpu_torch.io import parse_obj
    from opencl_ray_tracer_tpu_torch.io.procgen import make_torus_obj
    from opencl_ray_tracer_tpu_torch.kernels import intersect_mm as im
    tris, aabb = parse_obj(make_torus_obj(48, 24))
    scene = split_boxes(ot.reference_scene(mesh_tris=tris,
                                           mesh_aabb=aabb)).to(cuda)
    tab = im.mesh_tables(scene)
    rng = np.random.default_rng(6)
    o = torch.tensor(rng.normal(0.0, 2.0, (8192, 3)).astype(np.float32),
                     device=cuda)
    target = torch.tensor(rng.uniform(aabb[0], aabb[1], (8192, 3)).astype(
        np.float32), device=cuda)
    d = (target - o).contiguous()
    t, idx = im.closest_tri(tab, o, d, 1e-3)
    tp, ip = im.closest_tri_plain(tab, o, d, 1e-3)
    hit = tp < 1e38
    assert hit.float().mean() > 0.05
    same = idx == ip
    assert same.float().mean() >= 0.9999
    rel = ((t - tp).abs() / tp.abs().clamp(min=1e-30))[same & hit]
    assert rel.max() <= 1e-6


@pytest.mark.gpu
def test_closest_tri_walks_groups_as_the_earlier_design(cuda):
    """K3 walks the mesh with the group tables (``table_args``): on the
    2,304-triangle torus over 40 gating boxes it
    agrees with its plain version as above, and its t, indices and
    triangle tests equal the earlier design's (a block-wide vote per chunk,
    from the measurement build ORT_K3_VARIANTS) bit for bit."""
    import chip_smoke
    from opencl_ray_tracer_tpu_torch.io import parse_obj
    from opencl_ray_tracer_tpu_torch.io.procgen import make_torus_obj
    from opencl_ray_tracer_tpu_torch.kernels import _build
    from opencl_ray_tracer_tpu_torch.kernels import intersect_mm as im
    tris, aabb = parse_obj(make_torus_obj(48, 24))
    scene = split_boxes(ot.reference_scene(mesh_tris=tris,
                                           mesh_aabb=aabb)).to(cuda)
    tab = im.mesh_tables(scene)
    rng = np.random.default_rng(7)
    o = torch.tensor(rng.normal(0.0, 2.0, (20000, 3)).astype(np.float32),
                     device=cuda)
    target = torch.tensor(rng.uniform(aabb[0], aabb[1], (20000, 3)).astype(
        np.float32), device=cuda)
    d = (target - o).contiguous()
    tests = torch.zeros(1, dtype=torch.int64, device=cuda)
    t, idx = im.closest_tri(tab, o, d, 1e-3, tests=tests)
    lib = _build.load("intersect_mm", {}, ("ORT_K3_VARIANTS",))
    e_tests = torch.zeros(15, dtype=torch.int64, device=cuda)
    te, ie = chip_smoke.k3_variant(
        lib, chip_smoke.K3_VARIANTS.index("earlier_k3"), tab, o, d)(e_tests)
    torch.cuda.synchronize()
    assert torch.equal(t, te) and torch.equal(idx, ie.long())
    assert tests.item() == e_tests[0].item() > 0
    tp, ip = im.closest_tri_plain(tab, o, d, 1e-3)
    hit = tp < 1e38
    assert hit.float().mean() > 0.05
    same = idx == ip
    assert same.float().mean() >= 0.9999
    rel = ((t - tp).abs() / tp.abs().clamp(min=1e-30))[same & hit]
    assert rel.max() <= 1e-6


@pytest.mark.gpu
def test_plain_route_launches_closest_tri(cuda):
    """backend "jnp": the plain tracer on the card, whose triangle hit from
    256 triangles is the closest-triangle kernel; its image agrees with
    the mesh megakernel's under the image tolerance."""
    from opencl_ray_tracer_tpu_torch.io import parse_obj
    from opencl_ray_tracer_tpu_torch.io.procgen import make_torus_obj
    from opencl_ray_tracer_tpu_torch.kernels import intersect_mm as im
    from opencl_ray_tracer_tpu_torch.kernels import megamesh as mm
    tris, aabb = parse_obj(make_torus_obj(24, 12), scale=(0.5, 0.5, 0.5),
                           translate=(0.3, 0.0, -1.6))
    scene = ot.reference_scene(mesh_tris=tris, mesh_aabb=aabb)
    cfg = ot.RenderConfig(width=48, height=32, spp=3, max_depth=5)
    k3, k2 = im.LAUNCHES, mm.LAUNCHES
    plain = ot.render(scene, cfg.replace(backend="jnp"), seed=1)
    torch.cuda.synchronize()
    assert im.LAUNCHES > k3 and mm.LAUNCHES == k2
    fused = ot.render(scene, cfg, seed=1)
    assert mm.LAUNCHES == k2 + 1
    diff = (plain - fused).abs()
    assert (diff > 1e-3).float().mean() < 0.005
    assert (diff <= 1e-4).float().mean() > 0.99


MESH_GRAD_LEAVES = GRAD_LEAVES + (
    "triangles.p0", "triangles.p1", "triangles.p2", "triangles.albedo",
    "triangles.fuzz", "triangles.ior")


def _mesh_grad_scenes():
    """The mesh backward's cases, with the tolerances per leaf of
    tests/test_megagrad.py's mesh tests: the fuzzy-metal torus with the
    reference spheres (5e-4; focus_dist, a near-cancelling sum, at the
    reference scene's 5e-3), and the same torus as a Lambertian mesh
    without spheres (camera leaves, 1e-4)."""
    from opencl_ray_tracer_tpu_torch.scene import materials as mat
    scenes = mesh_scenes()
    mesh = scenes["mesh"]
    t = mesh.triangles
    lamb = dataclasses.replace(mesh, spheres=ot.Spheres.empty(),
                               triangles=dataclasses.replace(
                                   t, mat_type=torch.full_like(
                                       t.mat_type, mat.LAMBERTIAN)))
    tol = {k: 5e-4 for k in MESH_GRAD_LEAVES}
    return {"mesh": (mesh, {**tol, "camera.focus_dist": 5e-3}),
            "mesh_only": (lamb, {"camera.look_from": 1e-4,
                                 "camera.look_at": 1e-4,
                                 "camera.vfov_deg": 1e-4})}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(_mesh_grad_scenes()))
def test_mesh_grad_kernel_matches_plain_on_card(cuda, case):
    from opencl_ray_tracer_tpu_torch.kernels import megamesh as mm
    scene, tol = _mesh_grad_scenes()[case]
    scene = scene.to(cuda)
    cfg = ot.RenderConfig(width=50, height=30, spp=4, max_depth=6,
                          nan_policy="zero")
    img = ot.render(scene, cfg, seed=3)
    g_img = (2.0 / img.numel()) * img
    before = mg.MESH_LAUNCHES
    got = mg.render_grad_scene(scene, cfg, g_img, seed=3)
    torch.cuda.synchronize()
    assert mg.MESH_LAUNCHES == before + 1
    tab = mm.mesh_tables(scene)
    g = (g_img.reshape(-1, 3) / cfg.spp).T.contiguous()
    gcam, gsph, gtri = mg.render_grad_mesh_tables_plain(
        mm.mesh_camera_table(scene), mk.sphere_table(scene),
        scene.spheres.count, tab, cfg, scene.sky.kind,
        mm.specialize_mesh_flags(scene), g[0], g[1], g[2], 3,
        cfg.width * cfg.height)
    want = mg.tri_grads_to_scene(scene, tab.plan, gtri,
                                 mg.table_grads_to_scene(scene, gcam, gsph))
    a, b = scene_to_numpy(got), scene_to_numpy(want)
    errs = {k: float(np.abs(a[k] - b[k]).max())
            / max(float(np.abs(b[k]).max()), 1e-6) for k in tol}
    assert all(errs[k] < tol[k] for k in tol), errs
    assert np.abs(b["triangles.p0"]).max() > 0


@pytest.mark.gpu
def test_mesh_grad_sampled_runs_k2_and_k5(cuda):
    """The mesh route of render_grad_sampled: one launch of the mesh
    megakernel and one of the mesh backward per fwd+bwd, no sphere kernel
    and no plain version."""
    from opencl_ray_tracer_tpu_torch.kernels import megamesh as mm
    scene = mesh_scenes()["mesh"]
    cfg = ot.RenderConfig(width=40, height=24, spp=3, max_depth=5)
    counts = (mm.LAUNCHES, mg.MESH_LAUNCHES, mk.LAUNCHES, mg.LAUNCHES)
    loss, img, grads = ot.render_grad_sampled(
        scene, cfg, lambda im: torch.mean(im ** 2), seed=2)
    torch.cuda.synchronize()
    assert (mm.LAUNCHES, mg.MESH_LAUNCHES, mk.LAUNCHES, mg.LAUNCHES) == (
        counts[0] + 1, counts[1] + 1, counts[2], counts[3])
    assert img.device.type == "cuda" and torch.isfinite(loss)
    assert torch.isfinite(grads.triangles.p0).all()
    assert grads.triangles.p0.abs().max() > 0


@pytest.mark.gpu
def test_mesh_grad_plain_route_launches_closest_tri(cuda):
    """render_grad_sampled(grad_backend="plain") on a mesh scene: the
    winner search of its autograd is the closest-triangle kernel; the mesh
    backward does not run."""
    from opencl_ray_tracer_tpu_torch.kernels import intersect_mm as im
    scene = mesh_scenes()["mesh"]
    cfg = ot.RenderConfig(width=24, height=16, spp=2, max_depth=4)
    k3, k5 = im.LAUNCHES, mg.MESH_LAUNCHES
    loss, _, grads = ot.render_grad_sampled(
        scene, cfg, lambda im_: torch.mean(im_ ** 2), seed=2,
        grad_backend="plain")
    torch.cuda.synchronize()
    assert im.LAUNCHES > k3 and mg.MESH_LAUNCHES == k5
    assert torch.isfinite(grads.triangles.p0).all()


@pytest.mark.gpu
def test_failing_mesh_grad_launch_raises(cuda, monkeypatch):
    class Failing:
        def mesh_megagrad_threads(self, n_items, n_spheres):
            return 128

        def mesh_megagrad_launch(self, *args):
            return 700

    monkeypatch.setattr(mg, "_library", lambda: Failing())
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        ot.render_grad_sampled(mesh_scenes()["mesh"],
                               ot.RenderConfig(width=8, height=4, spp=1,
                                               max_depth=2),
                               lambda im: im.mean())


def _k5_k7_inputs(cuda, kernel, cfg, seed):
    """K5's (the mesh scene under its gradient sky) or K7's (the same under
    the HDR sky of hdr_scenes) inputs on the card: the scene, its tables,
    the cotangent planes of mean(img^2) of the mesh megakernel's image,
    K7's sky values (None for K5), and the wrapper and its plain version as
    functions of counts."""
    from opencl_ray_tracer_tpu_torch.kernels import megamesh as mm
    scene = (mesh_scenes()["mesh"] if kernel == "k5"
             else hdr_scenes()["mesh"]).to(cuda)
    cam, sph, n, tab, flags, image = mm.mesh_inputs(scene, cuda)
    n_pix = cfg.width * cfg.height
    img = torch.stack(mm.render_mesh(cam, sph, n, tab, cfg, scene.sky.kind,
                                     flags, seed, n_pix, sky_image=image))
    g = ((2.0 / img.numel() / cfg.spp) * img).contiguous()
    if kernel == "k5":
        sky = None
        args = (cam, sph, n, tab, cfg, scene.sky.kind, flags, g[0], g[1],
                g[2], seed, n_pix)
        fns = (mg.render_grad_mesh_tables, mg.render_grad_mesh_tables_plain)
    else:
        emit, _ = mg.hdr_emit(cam, sph, n, tab, cfg, flags, seed, n_pix)
        sky, _ = mg.hdr_lookup(image, emit)
        args = (cam, sph, n, tab, cfg, flags, g[0], g[1], g[2], sky, seed,
                n_pix)
        fns = (mg.hdr_consume, mg.hdr_consume_plain)
    return (scene, (cam, sph, n, tab, flags), g, sky,
            *(lambda c=None, f=f: f(*args, counts=c) for f in fns))


# Per-leaf tolerances of K5 (the mesh case of _mesh_grad_scenes) and K7
# (chip_smoke.py phase 19's, for the leaves K7 writes).
_K5_K7_TOL = {"k5": {**{k: 5e-4 for k in MESH_GRAD_LEAVES},
                     "camera.focus_dist": 5e-3},
              "k7": {"spheres.albedo": 5e-3, "triangles.p0": 5e-4,
                     "triangles.p1": 5e-4, "triangles.p2": 5e-4,
                     "triangles.albedo": 5e-3}}


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["k5", "k7"])
def test_mesh_grad_kernels_stride_over_items(cuda, kernel):
    """More work items (pixel samples) than K5's and K7's resident threads:
    each thread takes several items of several pixels, reusing its records
    and carrying its camera cotangents from one to the next; the result
    matches the plain version's on the scene's leaves."""
    cfg = ot.RenderConfig(width=400, height=200, spp=4, max_depth=6,
                          nan_policy="zero")
    scene, (cam, sph, n, tab, flags), g, sky, kern, plain = _k5_k7_inputs(
        cuda, kernel, cfg, 3)
    lib = mg._library()
    threads = (lib.mesh_megagrad_threads if kernel == "k5"
               else lib.hdr_consume_threads)(g.shape[1] * cfg.spp, n)
    assert 0 < threads < g.shape[1] * cfg.spp
    leaves = []
    for gcam, gsph, gtri in (kern(), plain()):
        leaves.append(scene_to_numpy(mg.tri_grads_to_scene(
            scene, tab.plan, gtri,
            mg.table_grads_to_scene(scene, gcam, gsph))))
    a, b = leaves
    tol = _K5_K7_TOL[kernel]
    errs = {k: float(np.abs(a[k] - b[k]).max())
            / max(float(np.abs(b[k]).max()), 1e-6) for k in tol}
    assert all(errs[k] < tol[k] for k in tol), errs
    # K7's camera and vertex cotangents are zero: the nearest texel and an
    # emitter's radiance do not move with the path's geometry
    assert np.abs(b["triangles.p0" if kernel == "k5"
                    else "triangles.albedo"]).max() > 0


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["k5", "k7"])
def test_mesh_grad_kernels_camera_cotangents_repeat(cuda, kernel):
    """Two launches of K5 (K7) on the same inputs give equal camera
    cotangents, at depth 32 with several items per thread (K7's are zero,
    as its vertex cotangents)."""
    cfg = ot.RenderConfig(width=400, height=200, spp=4, max_depth=32,
                          nan_policy="zero")
    *_, kern, _ = _k5_k7_inputs(cuda, kernel, cfg, 3)
    first, second = kern()[0], kern()[0]
    assert torch.equal(first, second)
    assert (first.abs().max() > 0) == (kernel == "k5")


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["k5", "k7"])
def test_mesh_grad_kernels_count_as_the_earlier_design(cuda, kernel):
    """K5 (K7) and its earlier design (a pixel per thread, from the
    measurement build ORT_K5_VARIANTS) on the same tables: the same
    bounces replayed and walked back, triangle tests and triangle bounces
    walked back, and cotangents within 1e-4 of each block's scale (their
    atomics add in other orders)."""
    import chip_smoke
    from opencl_ray_tracer_tpu_torch.kernels import _build
    cfg = ot.RenderConfig(width=160, height=90, spp=3, max_depth=8,
                          nan_policy="zero")
    scene, (cam, sph, n, tab, flags), g, sky, kern, _ = _k5_k7_inputs(
        cuda, kernel, cfg, 5)
    lib = _build.load("megagrad", {}, ("ORT_K5_VARIANTS",))
    earlier, _ = chip_smoke.k5_variant(
        lib, chip_smoke.K5_VARIANTS.index(f"earlier_{kernel}"), cam, sph, n,
        tab, cfg, scene.sky.kind, flags, g, 5, sky)
    kc = torch.zeros(4, dtype=torch.int64, device=cuda)
    ec = torch.zeros(7, dtype=torch.int64, device=cuda)
    got, want = kern(kc), earlier(ec)
    torch.cuda.synchronize()
    assert kc.tolist() == ec[:4].tolist() and kc[3] > 0
    assert chip_smoke.rel_blocks(got, want) < 1e-4


@pytest.mark.gpu
def test_failing_hdr_consume_launch_raises(cuda, monkeypatch):
    cfg = ot.RenderConfig(width=8, height=4, spp=1, max_depth=2,
                          nan_policy="zero")
    _, (cam, sph, n, tab, flags), g, sky, _, _ = _k5_k7_inputs(
        cuda, "k7", cfg, 0)

    class Failing:
        def hdr_consume_threads(self, n_items, n_spheres):
            return 128

        def hdr_consume_launch(self, *args):
            return 700

    monkeypatch.setattr(mg, "_library", lambda: Failing())
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        mg.hdr_consume(cam, sph, n, tab, cfg, flags, g[0], g[1], g[2], sky,
                       0, g.shape[1])


def hdr_scenes():
    """The HDR cases: tests/test_megamesh.py's mesh scene and the README
    spheres under its tone-mapped procedural sky."""
    from opencl_ray_tracer_tpu_torch.io.hdr import tone_map
    from opencl_ray_tracer_tpu_torch.io.procgen import make_sky_image
    sky = ot.Sky.hdr(tone_map(make_sky_image(64, 32)))
    return {"mesh": dataclasses.replace(mesh_scenes()["mesh"], sky=sky),
            "readme": dataclasses.replace(ot.readme_scene(), sky=sky)}


@pytest.mark.gpu
def test_hdr_texels_match_plain_on_card(cuda):
    """The kernels' HDR lookup and the plain version's pick the same texel
    of a 1024x512 image on 2^20 directions."""
    from opencl_ray_tracer_tpu_torch.kernels import megamesh as mm
    from opencl_ray_tracer_tpu_torch.scene.sky import texel_index
    gen = torch.Generator(device=cuda).manual_seed(3)
    d = torch.randn((2**20, 3), generator=gen, device=cuda)
    y, x = texel_index(torch.zeros((512, 1024, 3), device=cuda), d)
    assert torch.equal(mm.hdr_texels(d, 1024, 512), y * 1024 + x)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(hdr_scenes()))
def test_hdr_forward_matches_plain_on_card(cuda, case):
    """K2's HDR body against its plain version on the same inputs, and
    render() through it."""
    from opencl_ray_tracer_tpu_torch.kernels import megamesh as mm
    scene = hdr_scenes()[case]
    cfg = ot.RenderConfig(width=48, height=32, spp=4, max_depth=6)
    cam, sph, n, tab, flags, image = mm.mesh_inputs(scene, cuda)
    args = (cam, sph, n, tab, cfg, scene.sky.kind, flags, 5,
            cfg.width * cfg.height)
    k = torch.stack(mm.render_mesh(*args, sky_image=image), -1)
    p = torch.stack(mm.render_mesh_plain(*args, sky_image=image), -1)
    diff = (k - p).abs()
    assert (diff > 1e-3).float().mean() < 0.005
    assert (diff <= 1e-4).float().mean() > 0.99
    before = mm.LAUNCHES
    img = ot.render(scene, cfg, seed=5)
    assert mm.LAUNCHES == before + 1
    assert torch.equal(img.reshape(-1, 3), k)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(hdr_scenes()))
def test_hdr_passes_match_plain_on_card(cuda, case):
    """K6 against hdr_emit_plain, K7 against hdr_consume_plain on the same
    sky values and image cotangent, and the fused route's leaves against
    the plain route's."""
    from opencl_ray_tracer_tpu_torch.kernels import megamesh as mm
    scene = hdr_scenes()[case]
    cfg = ot.RenderConfig(width=40, height=24, spp=3, max_depth=5,
                          nan_policy="zero")
    cam, sph, n, tab, flags, image = mm.mesh_inputs(scene, cuda)
    n_pix = cfg.width * cfg.height
    emit, emis = mg.hdr_emit(cam, sph, n, tab, cfg, flags, 2, n_pix)
    pemit, pemis = mg.hdr_emit_plain(cam, sph, n, tab, cfg, flags, 2, n_pix)
    same = ((emit - pemit).abs().amax(0) <= 1e-6).float().mean()
    assert same >= 0.999
    assert float((emis - pemis).abs().max()) <= 1e-6
    sky, _ = mg.hdr_lookup(image, emit)
    img = mg.hdr_image(emit, emis, sky, cfg)
    g = ((2.0 / img.numel() / cfg.spp) * img).contiguous()
    k = mg.hdr_consume(cam, sph, n, tab, cfg, flags, g[0], g[1], g[2], sky,
                       2, n_pix)
    p = mg.hdr_consume_plain(cam, sph, n, tab, cfg, flags, g[0], g[1], g[2],
                             sky, 2, n_pix)
    rows = [mk.F_ALR, mk.F_ALG, mk.F_ALB]
    assert float((k[1][rows] - p[1][rows]).abs().max()) <= 1e-4 * float(
        p[1][rows].abs().max())
    counts = (mg.EMIT_LAUNCHES, mg.CONSUME_LAUNCHES, mm.LAUNCHES)
    loss, _, grads = ot.render_grad_sampled(
        scene, cfg, lambda im: torch.mean(im ** 2), seed=2)
    assert (mg.EMIT_LAUNCHES, mg.CONSUME_LAUNCHES, mm.LAUNCHES) == (
        counts[0] + 1, counts[1] + 1, counts[2])
    ploss, _, pgrads = ot.render_grad_sampled(
        scene, cfg, lambda im: torch.mean(im ** 2), seed=2,
        grad_backend="plain")
    assert abs(float(loss) - float(ploss)) <= 1e-5 * float(ploss)
    a, b = scene_to_numpy(grads), scene_to_numpy(pgrads)
    for key in ("spheres.albedo", "sky.image"):
        assert np.abs(b[key]).max() > 0
        assert (np.abs(a[key] - b[key]).max()
                <= 5e-3 * np.abs(b[key]).max()), key


@pytest.mark.gpu
def test_hdr_emit_repeats_as_the_earlier_design(cuda):
    """Two launches of K6 give equal records and non-sky sums (the kernel
    writes each sample's non-sky row and its second pass adds a pixel's
    rows in sample order), with more pixel samples than resident lanes, so
    that each lane takes several; both
    equal the earlier design's (a thread per pixel, from the measurement
    build ORT_K6_VARIANTS) bit for bit, with its bounces and triangle
    tests."""
    import chip_smoke
    from opencl_ray_tracer_tpu_torch.kernels import _build
    from opencl_ray_tracer_tpu_torch.kernels import megamesh as mm
    cfg = ot.RenderConfig(width=640, height=360, spp=3, max_depth=8,
                          nan_policy="zero")
    cam, sph, n, tab, flags, _ = mm.mesh_inputs(hdr_scenes()["mesh"], cuda)
    n_pix = cfg.width * cfg.height
    counts = torch.zeros(2, dtype=torch.int64, device=cuda)
    first = mg.hdr_emit(cam, sph, n, tab, cfg, flags, 4, n_pix,
                        counts=counts)
    first = tuple(x.clone() for x in first)
    second = mg.hdr_emit(cam, sph, n, tab, cfg, flags, 4, n_pix)
    lib = _build.load("megagrad", {}, ("ORT_K6_VARIANTS",))
    e_counts = torch.zeros(3, dtype=torch.int64, device=cuda)
    earlier = chip_smoke.k6_variant(
        lib, chip_smoke.K6_VARIANTS.index("earlier_k6"), cam, sph, n, tab,
        cfg, flags, 4)(e_counts)
    torch.cuda.synchronize()
    for a, b, c in zip(first, second, earlier):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert float(first[1].abs().max()) > 0
    assert counts.tolist() == e_counts[:2].tolist() and counts[1] > 0


@pytest.mark.gpu
def test_hdr_emit_without_triangles(cuda):
    """K6 on a scene without triangles (no chunk, gating box or group:
    ``empty_tables``), with each lane taking several pixels, against its
    plain version; it runs no triangle test."""
    from opencl_ray_tracer_tpu_torch.kernels import megamesh as mm
    cfg = ot.RenderConfig(width=640, height=360, spp=2, max_depth=6,
                          nan_policy="zero")
    cam, sph, n, tab, flags, _ = mm.mesh_inputs(hdr_scenes()["readme"],
                                                cuda)
    assert tab.chunk_box.shape[0] == tab.group_end.shape[0] == 0
    n_pix = cfg.width * cfg.height
    counts = torch.zeros(2, dtype=torch.int64, device=cuda)
    emit, emis = mg.hdr_emit(cam, sph, n, tab, cfg, flags, 3, n_pix,
                             counts=counts)
    pemit, pemis = mg.hdr_emit_plain(cam, sph, n, tab, cfg, flags, 3, n_pix)
    same = ((emit - pemit).abs().amax(0) <= 1e-6).float().mean()
    assert same >= 0.999
    assert float((emis - pemis).abs().max()) <= 1e-6
    assert counts[0] > n_pix * cfg.spp and counts[1] == 0


@pytest.mark.gpu
def test_hdr_render_and_grad_on_card(cuda):
    """render_and_grad under an HDR sky on the card (autograd of the plain
    per-sample tracer there) against the same on the CPU."""
    scene = hdr_scenes()["mesh"]
    cfg = ot.RenderConfig(width=24, height=16, spp=2, max_depth=4,
                          nan_policy="zero")
    loss, grads = ot.render_and_grad(scene, cfg,
                                     lambda im: torch.mean(im ** 2), seed=2)
    closs, cgrads = ot.render_and_grad(scene, cfg,
                                       lambda im: torch.mean(im ** 2),
                                       seed=2, device="cpu")
    assert grads.sky.image.device.type == "cuda"
    assert abs(float(loss) - float(closs)) <= 1e-4 * float(closs)
    a, b = scene_to_numpy(grads), scene_to_numpy(cgrads)
    for key in ("spheres.albedo", "sky.image"):
        assert np.abs(b[key]).max() > 0
        assert (np.abs(a[key] - b[key]).max()
                <= 5e-3 * np.abs(b[key]).max()), key


@pytest.mark.gpu
def test_failing_hdr_launch_raises(cuda, monkeypatch):
    class Failing:
        def hdr_emit_launch(self, *args):
            return 700

    monkeypatch.setattr(mg, "_library", lambda: Failing())
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        ot.render_grad_sampled(hdr_scenes()["readme"],
                               ot.RenderConfig(width=8, height=4, spp=1,
                                               max_depth=2),
                               lambda im: im.mean())



def _window_cases():
    return {"sphere": ot.readme_scene(), "mesh": mesh_scenes()["mesh"],
            "hdr": hdr_scenes()["mesh"]}


def _window_launcher(scene, cuda, plain=False):
    """launch(cfg, sample_base, acc0, mean) -> (n_pix, 3) of K1 (a sphere
    scene under a gradient sky) or K2 on the scene's inputs, or (plain) of
    the kernel's plain version; seed 7."""
    from opencl_ray_tracer_tpu_torch.kernels import megamesh as mm
    from opencl_ray_tracer_tpu_torch.scene.sky import KIND_HDR
    if scene.triangles.count == 0 and scene.sky.kind != KIND_HDR:
        s = scene.to(cuda)
        fn = mk.render_spheres_plain if plain else mk.render_spheres
        head = (mk.camera_table(s), mk.sphere_table(s), s.spheres.count)
        tail = (s.sky.kind, mk.specialize_flags(s), 7)
        kw = {}
    else:
        cam, sph, n, tab, flags, image = mm.mesh_inputs(scene, cuda)
        fn = mm.render_mesh_plain if plain else mm.render_mesh
        head = (cam, sph, n, tab)
        tail = (scene.sky.kind, flags, 7)
        kw = {"sky_image": image}

    def launch(cfg, sample_base=0, acc0=None, mean=True):
        return torch.stack(fn(*head, cfg, *tail, cfg.width * cfg.height,
                              sample_base=sample_base, acc0=acc0, mean=mean,
                              **kw), -1)

    return launch


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["zero", "running_sum"])
@pytest.mark.parametrize("case", ["sphere", "mesh", "hdr"])
def test_window_kernels_sum_to_one_shot(cuda, case, policy):
    """K1 and K2 (mesh and HDR bodies) in window mode: windows that tile
    the samples, each from the sums before it (acc0) and returning the raw
    sum, give the one-shot launch's sum bit for bit, and its mean divided
    as the kernel divides is the one-shot mean; a window against its plain
    version under the forward tolerance."""
    from opencl_ray_tracer_tpu_torch._fp import div
    launch = _window_launcher(_window_cases()[case], cuda)
    cfg = ot.RenderConfig(width=50, height=30, spp=6, max_depth=6,
                          nan_policy=policy)
    acc = None
    for s0, n in ((0, 2), (2, 3), (5, 1)):
        acc = launch(cfg.replace(spp=n), s0,
                     None if acc is None else acc.T.contiguous(), False)
    assert torch.equal(acc, launch(cfg, mean=False))
    assert torch.equal(div(acc, 6), launch(cfg))
    start = launch(cfg.replace(spp=2), mean=False).T.contiguous()
    got = launch(cfg.replace(spp=3), 2, start, False)
    want = _window_launcher(_window_cases()[case], cuda, plain=True)(
        cfg.replace(spp=3), 2, start, False)
    diff = (got - want).abs() / 5
    assert (diff > 1e-3).float().mean() < 0.005
    assert (diff <= 1e-4).float().mean() > 0.99


@pytest.mark.gpu
def test_window_acc0_checked(cuda):
    launch = _window_launcher(ot.readme_scene(), cuda)
    cfg = ot.RenderConfig(width=8, height=4, spp=1, max_depth=2)
    with pytest.raises(ValueError, match="acc0"):
        launch(cfg, acc0=torch.zeros((32, 3), device=cuda))
    with pytest.raises(ValueError, match="acc0"):
        launch(cfg, acc0=torch.zeros((3, 32)))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["sphere", "mesh", "hdr"])
def test_checkpointed_and_progressive_on_card(cuda, case, tmp_path):
    """render_checkpointed, interrupted and resumed, and render(progress=)
    through the kernels: equal to render() bit for bit, the kernel
    launched once per window and per row block."""
    from opencl_ray_tracer_tpu_torch.kernels import megamesh as mm
    scene = _window_cases()[case]
    cfg = ot.RenderConfig(width=48, height=24, spp=5, max_depth=5)
    want = ot.render(scene, cfg, seed=3)
    path = str(tmp_path / "c.npz")
    before = mk.LAUNCHES + mm.LAUNCHES
    ot.render_checkpointed(scene, cfg.replace(spp=2), path, seed=3,
                           chunk_spp=2)
    got = ot.render_checkpointed(scene, cfg, path, seed=3, chunk_spp=2)
    assert mk.LAUNCHES + mm.LAUNCHES == before + 3
    assert got.device.type == "cuda" and torch.equal(got, want)
    calls = []
    prog = ot.render(scene, cfg, seed=3, progress_blocks=4,
                     progress=lambda d, t, img: calls.append(
                         (d, t, img.device.type)))
    assert mk.LAUNCHES + mm.LAUNCHES == before + 7
    assert torch.equal(prog, want)
    assert calls == [(6, 24, "cuda"), (12, 24, "cuda"), (18, 24, "cuda"),
                     (24, 24, "cuda")]


@pytest.mark.gpu
def test_fit_resume_on_card(cuda, tmp_path):
    """A fit through K1 and K4 interrupted after 2 steps and resumed to 4
    follows the uninterrupted fit; K4's atomics add in another order from
    run to run, so the losses agree within 1e-5 relative."""
    true = ot.readme_scene()
    cfg = ot.RenderConfig(width=64, height=36, spp=4, max_depth=6)
    target = ot.render(true, cfg, seed=1)
    init = dataclasses.replace(true, spheres=dataclasses.replace(
        true.spheres, albedo=true.spheres.albedo + 0.1))
    kw = dict(param_paths=("spheres.albedo",), seed=2)
    _, full = ot.fit_scene(target, init, cfg, steps=4, **kw)
    path = str(tmp_path / "fit.pt")
    ot.fit_scene(target, init, cfg, steps=2, checkpoint_path=path,
                 checkpoint_every=1, **kw)
    _, resumed = ot.fit_scene(target, init, cfg, steps=4,
                              checkpoint_path=path, **kw)
    np.testing.assert_allclose(resumed, full, rtol=1e-5)


@pytest.mark.gpu
def test_cli_on_card(cuda, tmp_path):
    """The CLI without --cpu renders on the card, checkpointed with a
    progress image; its BMP is the tone-mapped render()."""
    import subprocess
    import sys
    from opencl_ray_tracer_tpu_torch.io import read_bmp, tonemap_u8
    out, ckpt = str(tmp_path / "out.bmp"), str(tmp_path / "c.npz")
    prog = str(tmp_path / "p.bmp")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, "-m", "opencl_ray_tracer_tpu_torch.cli", "render",
         "--scene", "readme", "--width", "64", "--height", "36", "--spp",
         "6", "--max-depth", "6", "--checkpoint", ckpt, "--chunk-spp", "4",
         "--progress-image", prog, "-o", out],
        capture_output=True, text=True, cwd=repo, timeout=600)
    assert r.returncode == 0, r.stderr
    assert "Rendered 6 / 6 samples" in r.stderr
    want = ot.render(ot.readme_scene(), ot.RenderConfig(
        width=64, height=36, spp=6, max_depth=6), seed=0)
    np.testing.assert_array_equal(read_bmp(out), tonemap_u8(want))
    np.testing.assert_array_equal(read_bmp(prog), tonemap_u8(want))


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["zero", "running_sum"])
def test_k1_windows_equal_one_shot_with_pixels_taken_twice(cuda, policy):
    """K1's lanes take a new pixel from the work counter when theirs ends:
    at 700x401 (280,700 pixels, more than the card's resident lanes and not
    a multiple of a block) windows that tile the samples still give the
    one-shot sum bit for bit, under both NaN policies, and the bounces of
    the one-shot launch equal the windows' together."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    cfg = ot.RenderConfig(width=700, height=401, spp=4, max_depth=5,
                          nan_policy=policy)
    n_pix = cfg.width * cfg.height
    assert n_pix > sms * 2048 and n_pix % 128 != 0
    s = ot.readme_scene().to(cuda)
    args = (mk.camera_table(s), mk.sphere_table(s), s.spheres.count)
    tail = (s.sky.kind, mk.specialize_flags(s), 7, n_pix)
    whole = torch.zeros(1, dtype=torch.int64, device=cuda)
    parts = torch.zeros(1, dtype=torch.int64, device=cuda)
    one = torch.stack(mk.render_spheres(*args, cfg, *tail, mean=False,
                                        bounces=whole))
    acc = None
    for s0, n in ((0, 1), (1, 2), (3, 1)):
        acc = torch.stack(mk.render_spheres(
            *args, cfg.replace(spp=n), *tail, sample_base=s0, acc0=acc,
            mean=False, bounces=parts))
    torch.cuda.synchronize()
    assert torch.equal(acc, one)
    assert whole.item() == parts.item()


def _duplicated_mesh():
    """The tests/test_megamesh.py torus with every triangle twice, beside
    a grid of edge-sharing triangles facing the camera: every hit of the
    torus is a tie of two triangles at one t."""
    from opencl_ray_tracer_tpu_torch.io import parse_obj
    from opencl_ray_tracer_tpu_torch.io.procgen import make_torus_obj
    tris, _ = parse_obj(make_torus_obj(12, 8), scale=(0.5, 0.5, 0.5),
                        translate=(0.3, 0.0, -1.6))
    xs = np.linspace(-1.2, -0.2, 9, dtype=np.float32)
    ys = np.linspace(-0.4, 0.6, 9, dtype=np.float32)
    grid = []
    for i in range(8):
        for j in range(8):
            a = (xs[i], ys[j], -1.5)
            b = (xs[i + 1], ys[j], -1.5)
            c = (xs[i], ys[j + 1], -1.5)
            d = (xs[i + 1], ys[j + 1], -1.5)
            grid += [(a, b, c), (b, d, c)]
    tv = np.concatenate([tris, tris, np.array(grid, np.float32)])
    aabb = (tv.reshape(-1, 3).min(0), tv.reshape(-1, 3).max(0))
    return ot.reference_scene(mesh_tris=tv, mesh_aabb=aabb)


@pytest.mark.gpu
def test_mesh_walk_ties_take_the_lower_index(cuda):
    """The grouped walk keeps the winner rule: the first plan index of the
    smallest t.  Each column of the tables gets a normal of its own, so
    the image shows which of two tied triangles won; K2 against its plain
    version (whose winner search is closest_tri_plain), and K3's indices
    against closest_tri_plain's on the camera rays."""
    from opencl_ray_tracer_tpu_torch.kernels import intersect_mm as im
    from opencl_ray_tracer_tpu_torch.kernels import megamesh as mm
    from opencl_ray_tracer_tpu_torch.tracer.mesh_accel import T_N
    scene = _duplicated_mesh().to(cuda)
    tab = mm.mesh_tables(scene)
    j = torch.arange(tab.tri.shape[1], device=cuda, dtype=torch.float32)
    nrm = torch.stack([torch.cos(j), torch.sin(j), torch.ones_like(j)])
    tri = tab.tri.clone()
    tri[T_N:T_N + 3] = nrm / nrm.norm(dim=0)
    tab = tab._replace(tri=tri)
    cfg = ot.RenderConfig(width=64, height=36, spp=2, max_depth=4)
    args = (mm.mesh_camera_table(scene), mk.sphere_table(scene),
            scene.spheres.count, tab, cfg, scene.sky.kind,
            mm.specialize_mesh_flags(scene), 3, cfg.width * cfg.height)
    got = torch.stack(mm.render_mesh(*args), -1)
    want = torch.stack(mm.render_mesh_plain(*args), -1)
    diff = (got - want).abs()
    assert (diff > 1e-3).float().mean() < 0.005
    assert (diff <= 1e-4).float().mean() > 0.99
    o = torch.zeros((4096, 3), device=cuda) + scene.camera.look_from
    g = torch.Generator(device="cpu").manual_seed(0)
    d = torch.stack([torch.rand(4096, generator=g) * 1.6 - 1.0,
                     torch.rand(4096, generator=g) * 1.0 - 0.5,
                     -torch.ones(4096)], 1).to(cuda) - o
    t_k, i_k = im.closest_tri(tab, o.contiguous(), d.contiguous(), 1e-3)
    t_p, i_p = im.closest_tri_plain(tab, o.contiguous(), d.contiguous(),
                                    1e-3)
    assert (i_k == i_p).float().mean() >= 0.9999


def _torus_15360():
    from opencl_ray_tracer_tpu_torch.io import parse_obj
    from opencl_ray_tracer_tpu_torch.io.procgen import make_torus_obj
    tris, aabb = parse_obj(make_torus_obj(128, 60), scale=(0.15,) * 3,
                           translate=(0.0, -0.5, -1.0))
    return ot.reference_scene(16 / 9, mesh_tris=tris, mesh_aabb=aabb)


@pytest.mark.gpu
def test_mesh_kernel_matches_plain_at_15360_triangles(cuda):
    """K2 with the grouped walk over 120 chunks (15 groups) against its
    plain version, the forward tolerance."""
    from opencl_ray_tracer_tpu_torch.kernels import megamesh as mm
    scene = _torus_15360().to(cuda)
    cfg = ot.RenderConfig(width=128, height=72, spp=2, max_depth=8)
    tab = mm.mesh_tables(scene)
    assert tab.chunk_box.shape[0] == 120 and tab.group_end.shape[0] == 15
    args = (mm.mesh_camera_table(scene), mk.sphere_table(scene),
            scene.spheres.count, tab, cfg, scene.sky.kind,
            mm.specialize_mesh_flags(scene), 5, cfg.width * cfg.height)
    got = torch.stack(mm.render_mesh(*args), -1)
    want = torch.stack(mm.render_mesh_plain(*args), -1)
    diff = (got - want).abs()
    assert (diff > 1e-3).float().mean() < 0.005
    assert (diff <= 1e-4).float().mean() > 0.99
    assert abs(float(got.mean() - want.mean())) < 2e-3


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["torus_576", "torus_15360", "many_boxes"])
def test_grouped_walk_runs_the_earlier_walks_triangle_tests(cuda, case):
    """K2 built with ORT_FLAT_WALK walks every chunk, as before the groups:
    the same image bit for bit, the same bounces and triangle tests."""
    from opencl_ray_tracer_tpu_torch.kernels import _build
    from opencl_ray_tracer_tpu_torch.kernels import megamesh as mm
    if case == "torus_576":
        from opencl_ray_tracer_tpu_torch.io import load_obj
        here = os.path.dirname(os.path.abspath(__file__))
        tris, aabb = load_obj(os.path.join(here, "..", "assets", "torus.obj"),
                              (0.15,) * 3, (0.0, -0.5, -1.0))
        scene = ot.reference_scene(16 / 9, mesh_tris=tris, mesh_aabb=aabb)
    elif case == "torus_15360":
        scene = _torus_15360()
    else:
        scene = split_boxes(mesh_scenes()["mesh"])
    scene = scene.to(cuda)
    cfg = ot.RenderConfig(width=160, height=90, spp=3, max_depth=8)
    args = (mm.mesh_camera_table(scene), mk.sphere_table(scene),
            scene.spheres.count, mm.mesh_tables(scene), cfg, scene.sky.kind,
            mm.specialize_mesh_flags(scene), 9, cfg.width * cfg.height)
    flat = _build.load("megamesh", mm._SYMBOLS, ("ORT_FLAT_WALK",))
    out = {}
    for name, lib in (("grouped", mm._library()), ("flat", flat)):
        counts = torch.zeros(2, dtype=torch.int64, device=cuda)
        built = mm._library
        mm._library = lambda lib=lib: lib
        try:
            img = torch.stack(mm.render_mesh(*args, counts=counts))
        finally:
            mm._library = built
        torch.cuda.synchronize()
        out[name] = (img, counts.tolist())
    assert torch.equal(out["grouped"][0], out["flat"][0])
    assert out["grouped"][1] == out["flat"][1] and out["flat"][1][1] > 0
