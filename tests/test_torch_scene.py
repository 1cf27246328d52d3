"""raypt_torch scene and accel builds against the JAX package: frozen
scene leaves, the SAH tree, clusters and the encoded walk table.

The helpers here (JAX scene -> numpy leaves, JAX accel -> port accel)
are shared by the other test_torch_* files."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raypt.accel.ctree import (_bf16_down as jax_bf16_down,
                               _bf16_up as jax_bf16_up)
from raypt.accel.ctree import build_onehot as jax_build_onehot
from raypt.accel.host_bvh import build_sah as jax_build_sah
from raypt.accel.host_bvh import host_tree_to_lbvh as jax_host_tree_to_lbvh
from raypt.core.camera import Camera as JaxCamera
from raypt.scenes import builtin as jax_scenes

from raypt_torch.accel import ctree as tctree
from raypt_torch.accel import host_bvh as thost
from raypt_torch.accel.clusters import Clusters
from raypt_torch.accel.lbvh import LBVH
from raypt_torch.core.camera import Camera as TorchCamera
from raypt_torch.core.types import scene_from_numpy
from raypt_torch.io.native import build_sah_host
from raypt_torch.scenes import builtin as torch_scenes

torch.set_num_threads(2)

SCENES = ("stanford_bunny", "triangle_ground", "cornell_box",
          "cornell_box_with_bunny")
GROUPS = ("materials", "spheres", "mesh", "camera")


def jax_leaves(scene) -> dict:
    """numpy leaves of a frozen JAX Scene, keyed "<group>.<field>"."""
    out = {}
    for grp in GROUPS:
        obj = getattr(scene, grp)
        for f in dataclasses.fields(obj):
            out[f"{grp}.{f.name}"] = np.asarray(getattr(obj, f.name))
    out["env.data"] = np.asarray(scene.env.data)
    out["env.is_cube"] = scene.env.is_cube
    return out


def jax_lbvh_to_port(bvh) -> LBVH:
    return tctree.lbvh_from_numpy(*(getattr(bvh, k) for k in
                                    ("left", "skip", "bmin", "bmax",
                                     "leaf_face")))


def jax_accel_to_port(accel):
    """Port OnehotAccel from the JAX build_onehot output, the pair or,
    with with_woop=True, the 4-tuple with the Woop table."""
    clusters, table = accel[0], accel[1]
    return tctree.onehot_accel_from_numpy(
        np.asarray(clusters.tri_rows), np.asarray(clusters.bmin),
        np.asarray(clusters.bmax), np.asarray(clusters.valid),
        np.asarray(jax.lax.bitcast_convert_type(table, jnp.uint16)),
        *(np.asarray(x) for x in accel[2:4]))


def jax_clusters_to_port(clusters) -> Clusters:
    """Port Clusters from the JAX build_clusters output."""
    return Clusters(**{k: torch.from_numpy(np.array(getattr(clusters, k)))
                       for k in ("bmin", "bmax", "tri_rows", "valid")})


def _builders(name):
    return getattr(jax_scenes, name)(), getattr(torch_scenes, name)()


@pytest.mark.parametrize("name", SCENES)
def test_freeze_bitwise(name):
    """Every leaf of the frozen scene is bitwise equal, the camera frame
    included (measured: bitwise for both scenes), and scene_from_numpy
    reproduces the JAX leaves exactly."""
    jb, tb = _builders(name)
    leaves = jax_leaves(jb.freeze())
    scene = tb.freeze("cpu")
    bridged = scene_from_numpy(leaves, "cpu")
    for key, ref in leaves.items():
        if key == "env.is_cube":
            assert scene.env.is_cube == ref
            continue
        grp, field = key.split(".")
        for s in (scene, bridged):
            got = getattr(getattr(s, grp), field).numpy()
            assert got.dtype == ref.dtype and got.shape == ref.shape, key
            assert np.array_equal(got.view(np.uint8), ref.view(np.uint8)), key


def test_entry_points_default_to_the_card():
    """freeze() and scene_from_numpy() build on the card unless the
    caller names a device: where torch has no CUDA they raise torch's own
    error instead of returning CPU tensors."""
    jb, tb = _builders("triangle_ground")
    leaves = jax_leaves(jb.freeze())
    if torch.cuda.is_available():
        assert tb.freeze().mesh.positions.is_cuda
        assert scene_from_numpy(leaves).mesh.positions.is_cuda
        return
    for build in (tb.freeze, lambda: scene_from_numpy(leaves)):
        with pytest.raises((AssertionError, RuntimeError)):
            build()


@pytest.mark.parametrize("angles", [(0.0, 0.0), (0.0, 180.0), (-17.5, 33.0),
                                    (40.0, -120.0)])
def test_camera_rays_close(angles):
    """Camera.rays builds its rotation from float32 cos/sin and a 3x3
    product: numpy here, XLA in the JAX package. Tolerance 2 ulp of the
    vector's magnitude (measured worst case: 0 ulp, bitwise, on these
    angles)."""
    kw = dict(position=(1.5, -2.0, 3.25), angle_x=angles[0],
              angle_y=angles[1], viewport_width=64, viewport_height=48)
    ref = JaxCamera(**kw).rays()
    got = TorchCamera(**kw).rays()
    for f in ("origin", "lower_left", "horizontal", "vertical"):
        r = np.asarray(getattr(ref, f))
        g = getattr(got, f).numpy()
        ulp = np.spacing(np.abs(r).max().astype(np.float32))
        assert np.abs(g - r).max() <= 2 * ulp, (f, g, r)


def test_bf16_rounding_bitwise():
    """Conservative bf16 rounding of box bounds: bitwise vs the JAX
    package on random values of every magnitude, zeros and +-BIG."""
    rng = np.random.default_rng(3)
    x = np.concatenate([
        (rng.normal(size=4000) * 10.0 ** rng.integers(-20, 20, 4000)),
        [0.0, -0.0, 1e30, -1e30, 1.0, -1.0, 3.0, 1e-30]]).astype(np.float32)
    for jf, tf in ((jax_bf16_down, tctree._bf16_down),
                   (jax_bf16_up, tctree._bf16_up)):
        ref = np.asarray(jax.lax.bitcast_convert_type(jf(jnp.asarray(x)),
                                                      jnp.uint16))
        assert np.array_equal(tf(x), ref)


def test_sah_tree_bitwise_triangle_ground():
    """The whole SAH build, native library included, matches."""
    jb, tb = _builders("triangle_ground")
    ref = jax_build_sah(jb.freeze().mesh)
    got = thost.build_sah(tb.freeze("cpu").mesh)
    for k in ("left", "skip", "bmin", "bmax", "leaf_face"):
        assert np.array_equal(getattr(got, k), np.asarray(getattr(ref, k))), k


def test_sah_conversion_bitwise_bunny():
    """The port builds the native SAH without -march=native, so it emits
    no fused multiply-adds and, on the icosphere stand-in, near-tied
    split costs make a different (equally valid) tree than the committed
    library. The host-tree -> LBVH conversion is held bitwise on the same
    host output, and the port's own tree must be well formed."""
    jb, tb = _builders("stanford_bunny")
    mesh = tb.freeze("cpu").mesh
    faces = mesh.faces.numpy()
    vidx = np.nonzero(mesh.face_valid.numpy())[0]
    bounds, meta, order = build_sah_host(mesh.positions.numpy(), faces[vidx])
    order = vidx[order].astype(np.uint32)
    ref = jax_host_tree_to_lbvh(bounds, meta, order, mesh.num_faces)
    got = thost.host_tree_to_lbvh(bounds, meta, order, mesh.num_faces)
    for k in ("left", "skip", "bmin", "bmax", "leaf_face"):
        assert np.array_equal(getattr(got, k), np.asarray(getattr(ref, k))), k
    own = thost.build_sah(mesh)
    n_real = len(vidx)
    assert sorted(own.leaf_face[:n_real].tolist()) == vidx.tolist()
    _, counts, _, _, attached = tctree.tree_structure(own)
    assert counts[0] == n_real and attached[own.num_leaves - 1:][
        :n_real].all()


@pytest.mark.parametrize("leaf", [384, 16])
def test_onehot_accel_bitwise(leaf):
    """Given the JAX package's SAH tree of the bench bunny, the port's
    build_onehot gives bitwise the same clusters and walk table (as
    uint16), and onehot_accel_from_numpy carries them over exactly."""
    jscene = jax_scenes.stanford_bunny().freeze()
    jbvh = jax_build_sah(jscene.mesh)
    ref = jax_build_onehot(jbvh, jscene.mesh.positions, jscene.mesh.faces,
                           jscene.mesh.face_valid, leaf=leaf)
    tscene = torch_scenes.stanford_bunny().freeze("cpu")
    m = tscene.mesh
    got = tctree.build_onehot(jax_lbvh_to_port(jbvh), m.positions, m.faces,
                              m.face_valid, leaf=leaf)
    bridged = jax_accel_to_port(ref)
    for acc in (got, bridged):
        for k in ("tri_rows", "bmin", "bmax", "valid"):
            a = getattr(acc.clusters, k).numpy()
            b = np.asarray(getattr(ref[0], k))
            assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), k
        assert np.array_equal(
            tctree.table_bits(acc.table),
            np.asarray(jax.lax.bitcast_convert_type(ref[1], jnp.uint16)))


def test_bunny_mesh_override():
    """stanford_bunny(mesh=...) puts the given mesh where bunny_mesh()
    goes, with the same material, transform, ground and light: the
    icosphere it stands in for gives the default scene bitwise, and a
    finer one only more faces."""
    default = torch_scenes.stanford_bunny().freeze("cpu")
    same = torch_scenes.stanford_bunny(
        mesh=torch_scenes.bunny_mesh()).freeze("cpu")
    for grp in GROUPS:
        for f in dataclasses.fields(getattr(default, grp)):
            a = getattr(getattr(default, grp), f.name)
            b = getattr(getattr(same, grp), f.name)
            assert torch.equal(a, b), f"{grp}.{f.name}"
    fine = torch_scenes.stanford_bunny(
        mesh=torch_scenes._icosphere(5)).freeze("cpu")
    assert int(fine.mesh.face_valid.sum()) == 20480 + 2
    assert torch.equal(fine.materials.albedo, default.materials.albedo)
