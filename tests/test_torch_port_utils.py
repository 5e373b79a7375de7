"""PyTorch port, the host-side helpers against the JAX package on the CPU:
the voxel helpers of ``ops/voxel.py``, ``ops.get_surface_mask``,
``ops.reprojection_loss``, ``utils.camera`` (the depth map's upsampling
against cv2's through the JAX function), ``utils.cam_para``,
``utils.io.BatchSave``, ``train/introspect.py`` against the statistics
of the JAX gradient pytree, and ``--backbone_init`` from a checkpoint of
the JAX package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genre_shapehd_tpu import ops as jops
from genre_shapehd_tpu.core.checkpoint import save_checkpoint as jax_save
from genre_shapehd_tpu.core.registry import get_model as jax_model
from genre_shapehd_tpu.models.base import default_opt as jax_opt
from genre_shapehd_tpu.ops import voxel as jvoxel
from genre_shapehd_tpu.train import introspect as jintrospect
from genre_shapehd_tpu.utils import camera as jcamera
from genre_shapehd_tpu.utils import cam_para as jcam_para
from genre_shapehd_tpu.utils import io as jio
from genre_shapehd_tpu_torch import ops
from genre_shapehd_tpu_torch.core.convert import jax_to_torch, torch_to_jax
from genre_shapehd_tpu_torch.core.registry import get_model
from genre_shapehd_tpu_torch.models.base import default_opt
from genre_shapehd_tpu_torch.ops import voxel
from genre_shapehd_tpu_torch.train import introspect
from genre_shapehd_tpu_torch.utils import camera, cam_para, io

from _torch_port_util import release_memory

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _release():
    yield
    release_memory()


def _solid(res, seed):
    """A seeded union of two boxes in a res³ grid, float32."""
    rng = np.random.default_rng(seed)
    vox = np.zeros((res,) * 3, np.float32)
    for _ in range(2):
        lo = rng.integers(2, res // 2, 3)
        hi = lo + rng.integers(3, res // 2, 3)
        vox[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = 1.0
    return vox


def test_voxel_host_helpers_match_jax():
    """Each helper gives the JAX package's array bit for bit."""
    a, b = _solid(16, 0), _solid(16, 1)
    shell = np.clip(a - jvoxel.binary_erosion_jax(jnp.asarray(a), 1), 0, 1)
    shell = np.asarray(shell)
    rot = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    cases = [
        ("downsample max", lambda m: m.downsample(a, 2)),
        ("downsample mean", lambda m: m.downsample(a, 1, use_max=False)),
        ("find_bound", lambda m: m.find_bound(a)),
        ("find_bound empty", lambda m: m.find_bound(np.zeros((4,) * 3))),
        ("bounding_box_align", lambda m: m.bounding_box_align(a, b)),
        ("translate", lambda m: m.translate(a, np.array([2, -3, 1]))),
        ("transform_by_matrix", lambda m: m.transform_by_matrix(a, rot)),
        ("transform order 0", lambda m: m.transform_by_matrix(
            a, 0.8 * np.eye(3), order=0)),
        ("fill_solid", lambda m: m.fill_solid(shell)),
        ("surface_from_solid_np", lambda m: m.surface_from_solid_np(a)),
    ]
    for name, fn in cases:
        ref, got = fn(jvoxel), fn(voxel)
        assert got.dtype == ref.dtype and got.shape == ref.shape, name
        np.testing.assert_array_equal(got, ref, err_msg=name)
    # the solid fill recovers the solid from its one-voxel shell
    np.testing.assert_array_equal(voxel.fill_solid(shell), a)


def test_get_surface_mask_matches_jax():
    """Hit voxels and the carved free space of a (2, 24, 20) depth image
    (a focal length of 40 pixels keeps the cube inside the image), res
    16: equal to JAX's; some voxels carved, some hit."""
    rng = np.random.default_rng(2)
    d = rng.uniform(1.6, 2.6, (2, 24, 20)).astype(np.float32)
    d[:, :3] = -1.0
    ref = jops.get_surface_mask(jnp.asarray(d), fl=40.0, res=16)
    got = ops.get_surface_mask(torch.from_numpy(d), fl=40.0, res=16)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    surface, mask = (g.numpy() for g in got)
    assert 0 < surface.sum() and (mask == 0).sum() > 0


def test_reprojection_loss_matches_jax():
    rng = np.random.default_rng(3)
    res = 4
    c = (np.arange(res) + 0.5) / res - 0.5
    x = np.stack(np.meshgrid(c, c, c, indexing="ij"), -1).reshape(-1, 3)
    v = rng.random(res ** 3).astype(np.float32)
    x0 = rng.uniform(-0.4, 0.4, (5, 3)).astype(np.float32)
    n0 = np.array([0.3, -1.0, 0.4], np.float32)
    ref = float(jops.reprojection_loss(jnp.asarray(v), jnp.asarray(x),
                                       jnp.asarray(x0), jnp.asarray(n0),
                                       1.0 / res))
    got = float(ops.reprojection_loss(
        torch.from_numpy(v), torch.from_numpy(x.astype(np.float32)),
        torch.from_numpy(x0), torch.from_numpy(n0), 1.0 / res))
    assert ref > 0
    np.testing.assert_allclose(got, ref, rtol=1e-5)


def _camera(mod):
    cam = mod.Camera()
    cam.res = [32, 24]
    cam.set_diagonal((0.036 ** 2 + 0.024 ** 2) ** 0.5)
    cam.lookat(orig=[2.0, 0.5, 0.5], target=[0, 0, 0], up=[0, 1, 0])
    return cam


@pytest.mark.parametrize("upsample,depth_type", [
    (1.0, "ray"), (2.0, "ray"), (2.0, "plane"), (1.5, "ray")])
def test_camera_and_backprojection_match_jax(upsample, depth_type):
    """Projection, depths and the camera's packing; the point cloud of a
    depth map with background, upsampled bilinearly (JAX: cv2's
    INTER_LINEAR): the same pixels, the points within 1e-5."""
    ref_cam, cam = _camera(jcamera), _camera(camera)
    pts = np.array([[0.1, 0.05, -0.02], [-0.2, 0.1, 0.3]])
    for r, g in zip(ref_cam.project_point(pts), cam.project_point(pts)):
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-12)
    for t in ("ray", "plane"):
        np.testing.assert_allclose(cam.project_depth(pts, t),
                                   ref_cam.project_depth(pts, t), atol=0)
    assert cam.pack() == ref_cam.pack()
    tris = np.random.default_rng(4).random((6, 3, 3))
    for r, g in zip(jcamera.triangle_point_budget(tris, 50.0),
                    camera.triangle_point_budget(tris, 50.0)):
        np.testing.assert_array_equal(g, r)

    yy, xx = np.mgrid[:24, :32]
    depth = (2.0 + 0.01 * xx + 0.02 * yy).astype(np.float32)
    depth[(yy - 12) ** 2 + (xx - 15) ** 2 > 60] = -1.0
    ref_pts, ref_pix = jcamera.backproject_depth_to_ptcloud(
        depth, ref_cam, upsample, depth_type)
    got_pts, got_pix = camera.backproject_depth_to_ptcloud(
        depth, cam, upsample, depth_type)
    for r, g in zip(ref_pix, got_pix):
        np.testing.assert_array_equal(g, r)
    assert len(got_pts) > 100
    np.testing.assert_allclose(got_pts, ref_pts, rtol=0, atol=1e-5)


def test_cam_para_matches_jax(tmp_path):
    xml = """<scene><sensor type="perspective">
      <transform name="toWorld">
        <lookAt origin="1.5,0.8,1.0" target="0.1,0,-0.2" up="0,1,0"/>
      </transform>
      <film type="ldrfilm">
        <integer name="width" value="480"/>
        <integer name="height" value="360"/>
      </film>
    </sensor></scene>"""
    path = str(tmp_path / "cam.xml")
    with open(path, "w") as f:
        f.write(xml)
    assert cam_para.read_cam_para_from_xml(path) == \
        jcam_para.read_cam_para_from_xml(path)
    ref, got = (m.raw_camparam_from_xml(path) for m in (jcam_para, cam_para))
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    for style in ("zup", "yup"):
        np.testing.assert_array_equal(
            cam_para.get_object_rotation(path, style),
            jcam_para.get_object_rotation(path, style))
    for a in (-3.0, -0.7, 0.0, 0.3, 1.2, 3.1):
        for fn, inv, num in (("azimuth_to_onehot", "onehot_to_azimuth", 24),
                             ("elevation_to_onehot", "onehot_to_elevation",
                              12)):
            if "elevation" in fn and abs(a) > 1.5:
                continue
            oh = getattr(cam_para, fn)(a, num)
            np.testing.assert_array_equal(oh, getattr(jcam_para, fn)(a, num))
            assert getattr(cam_para, inv)(oh, num) == \
                getattr(jcam_para, inv)(oh, num)


def test_batch_save_matches_jax(tmp_path):
    """The same batches give the same shard files; the port also takes
    tensors, bfloat16 ones stored as float32."""
    rng = np.random.default_rng(5)
    batches = [{"a": rng.random((4, 2)).astype(np.float32),
                "b": list(range(4 * i, 4 * i + 4))} for i in range(3)]
    for mod, d in ((jio, "jax"), (io, "port")):
        bs = mod.BatchSave(str(tmp_path / d / "shard{ind:03d}"), filesize=5)
        for b in batches:
            bs.add_data(b)
        assert bs.get_buffer_size() == 2
        bs.close()
        assert bs.get_fileind() == 3              # 12 samples: 5 + 5 + 2
    for i in range(3):
        with np.load(tmp_path / "jax" / f"shard{i:03d}.npz") as r, \
                np.load(tmp_path / "port" / f"shard{i:03d}.npz") as g:
            assert sorted(g.files) == sorted(r.files)
            for k in r.files:
                np.testing.assert_array_equal(g[k], r[k])
    bs = io.BatchSave(str(tmp_path / "t" / "s{ind}"), filesize=2)
    bs.add_data({"x": torch.ones(2, 3, dtype=torch.bfloat16)})
    with np.load(tmp_path / "t" / "s0.npz") as z:
        assert z["x"].dtype == np.float32 and z["x"].sum() == 6


def test_introspect_matches_the_jax_pytree():
    """Seeded gradients on MarrNet-1's parameters (one left without a
    gradient): the global and per-module statistics over the module equal
    the JAX functions' over the same gradients as a pytree (the names of
    ``core/convert.py``), rtol 1e-5; the ring buffer alike."""
    tm = get_model("marrnet1")(default_opt(device="cpu", im_size=64,
                                           pred_depth_minmax=True))
    rng = np.random.default_rng(6)
    grads = {}
    for i, (name, p) in enumerate(tm.net.named_parameters()):
        p.grad = None if i == 3 else torch.from_numpy(
            rng.standard_normal(p.shape).astype(np.float32))
        grads[name] = p.grad if p.grad is not None else torch.zeros_like(p)
    tree, _ = torch_to_jax(grads)
    tree = jax.tree.map(jnp.asarray, tree)
    assert sorted(tree) == sorted({n.split(".")[0] for n in grads})
    for ref, got in ((jintrospect.grad_stats(tree),
                      introspect.grad_stats(tm.net)),
                     (jintrospect.per_module_grad_norms(tree),
                      introspect.per_module_grad_norms(tm.net))):
        assert sorted(got) == sorted(ref)
        for k, v in ref.items():
            np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-5,
                                       err_msg=k)
    stats = introspect.grad_stats(grads, prefix="g")
    bufs = (introspect.CircularGradBuffer(3),
            jintrospect.CircularGradBuffer(3))
    for step in range(5):
        for b in bufs:
            b.record(step, {k: v * step for k, v in stats.items()})
    assert bufs[0].latest() == bufs[1].latest()
    assert bufs[0].summary() == bufs[1].summary()


def test_backbone_init_reads_a_jax_encoder_checkpoint(tmp_path):
    """``--backbone_init`` loads a JAX-package checkpoint whose first net
    is a ``ResNet18Features`` tree (weights and batch statistics) into
    MarrNet-1's encoder, as the JAX model loads it into its own; the rest
    of the net keeps its seeded start."""
    jm = jax_model("marrnet1")(jax_opt(im_size=64, pred_depth_minmax=True))
    state = jm.init_state(jax.random.PRNGKey(3))
    rng = np.random.default_rng(7)
    sub = "ResNet18Features_0"
    params = jax.tree.map(
        lambda x: np.asarray(x) + rng.standard_normal(x.shape).astype(
            np.float32), state.params["net"][sub])
    stats = jax.tree.map(lambda x: np.asarray(x) + 0.5,
                         state.batch_stats["net"][sub])
    path = str(tmp_path / "backbone.pt")
    jax_save(path, {"nets": [{"params": params, "batch_stats": stats}],
                    "epoch": 0})

    jm_b = jax_model("marrnet1")(jax_opt(im_size=64, pred_depth_minmax=True,
                                         backbone_init=path))
    ref = jm_b.init_state(jax.random.PRNGKey(3))
    kw = dict(device="cpu", im_size=64, pred_depth_minmax=True)
    plain = get_model("marrnet1")(default_opt(**kw))
    plain.init_state(0)
    tm = get_model("marrnet1")(default_opt(backbone_init=path, **kw))
    tm.init_state(0)
    want = jax_to_torch(jax.tree.map(np.asarray, ref.params["net"][sub]),
                        jax.tree.map(np.asarray,
                                     ref.batch_stats["net"][sub]))
    got = tm.net.state_dict()
    for k, v in want.items():
        assert torch.equal(got[f"{sub}.{k}"], v), k
    for k, v in plain.net.state_dict().items():
        if not k.startswith(sub):
            assert torch.equal(got[k], v), k
