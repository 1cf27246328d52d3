"""raypt_torch's loaders, checkpoints and leftovers against the JAX
package: PLY and `load_mesh`, PPM and NPY bytes, the native OBJ parser
and smooth normals, render-state and pytree checkpoints written by one
package and loaded by the other, the transforms of `core.math3d`,
`SceneBuilder.freeze(pad=False)` and its counters and dirty flags, env
LOD (mip chain, LOD sampling, cube / equirect conversion), and the
debug-mode checked render (tests/test_debug.py's three cases)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from raypt.core import math3d as jm3
from raypt.core import scene as jscene_mod
from raypt.core.types import EnvMap as JEnv
from raypt.diff.params import SceneParams as JParams
from raypt.io import checkpoint as jck
from raypt.io import image as jimage
from raypt.io import native as jnative
from raypt.io import ply as jply
from raypt.render import envmap as jenv
from raypt.scenes import builtin as jscenes

from raypt_torch.app.debug import RenderCheckError, checked_render_frame
from raypt_torch.core import math3d as tm3
from raypt_torch.core import scene as tscene_mod
from raypt_torch.core.types import EnvMap, RenderConfig, scene_from_numpy
from raypt_torch.diff.params import FIELDS, SceneParams
from raypt_torch.io import checkpoint as tck
from raypt_torch.io import image as timage
from raypt_torch.io import native as tnative
from raypt_torch.io import obj as tobj
from raypt_torch.io import ply as tply
from raypt_torch.render import envmap as tenv
from raypt_torch.render.integrator import render_frame
from raypt_torch.rng.sampler import Key, key

from test_torch_scene import jax_leaves

# float results against the JAX package where the two compute in
# another order: the mip chain's 2x2 means (measured worst 1.2e-7), LOD
# samples (2.3e-6), the cube / equirect resamplings (3.2e-6: the
# normalised face directions), the rotations and transforms (0.0 here);
# the native smooth normals, which the JAX package's library computes
# with fused multiply-adds (fault 3.5; measured worst 1.6e-7, 1.2e-7
# against the numpy version)
ENV_ATOL = 1e-5
M3_ATOL = 1e-6
NORMALS_ATOL = 1e-6


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint8)


def _same_mesh(a, b, normals_exact=True):
    assert set(a) == set(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        if k == "normals" and not normals_exact:
            np.testing.assert_allclose(x, y, atol=NORMALS_ATOL)
        else:
            assert np.array_equal(_bits(x), _bits(y)), k


PLY_ASCII = b"""ply
format ascii 1.0
comment a quad and a triangle
element vertex 5
property float x
property float y
property float z
property float u
property float v
element face 2
property list uchar int vertex_indices
end_header
0 0 0 0 0
1 0 0 1 0
1 1 0 1 1
0 1 0 0 1
0.5 0.5 1 0.5 0.5
4 0 1 2 3
3 0 1 4
"""


def _ply_binary(endian: str) -> bytes:
    rng = np.random.default_rng(3)
    pos = rng.normal(size=(6, 3)).astype(np.float32)
    nrm = rng.normal(size=(6, 3)).astype(np.float32)
    head = (f"ply\nformat binary_{'little' if endian == '<' else 'big'}"
            f"_endian 1.0\nelement vertex 6\nproperty float x\nproperty "
            f"float y\nproperty float z\nproperty float nx\nproperty float "
            f"ny\nproperty float nz\nelement face 3\nproperty list uchar "
            f"uint vertex_indices\nend_header\n").encode()
    body = np.concatenate([pos, nrm], 1).astype(endian + "f4").tobytes()
    for poly in ((0, 1, 2), (2, 3, 4, 5), (5, 0, 1)):
        body += np.uint8(len(poly)).tobytes()
        body += np.asarray(poly, endian + "u4").tobytes()
    return head + body


@pytest.mark.parametrize("kind", ["ascii", "le", "be"])
def test_ply_bitwise(kind, tmp_path):
    """load_ply of ascii (a quad fan, uvs, generated normals) and binary
    little / big endian (normals, list faces) files, from a path and
    from bytes, and load_mesh of the path, equal to the JAX package's."""
    raw = {"ascii": PLY_ASCII, "le": _ply_binary("<"),
           "be": _ply_binary(">")}[kind]
    path = tmp_path / "m.ply"
    path.write_bytes(raw)
    want = jply.load_ply(str(path))
    _same_mesh(tply.load_ply(str(path)), want)
    _same_mesh(tply.load_ply(raw), want)
    _same_mesh(tply.load_mesh(str(path)), want)
    with pytest.raises(tply.PLYError):
        tply.load_ply(b"not a ply")


OBJ_TEXT = """# a quad and a triangle
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0.5 0.5 1
f 1 2 3 4
f 1 2 -1
"""
OBJ_CORNERS = """v 0 0 0
v 1 0 0
v 0 1 0
vt 0 0
vt 1 0
vt 0 1
vn 0 0 1
f 1/1/1 2/2/1 3/3/1
"""


def test_native_obj_and_load_mesh(tmp_path):
    """The native parser against the JAX package's (its committed
    library) and against the Python parser: positions, uvs and faces
    bitwise, smooth normals to NORMALS_ATOL; a file with per-corner
    indices is declined (None) and parsed in Python; load_mesh picks the
    OBJ loader by extension and by content."""
    path = tmp_path / "m.obj"
    path.write_text(OBJ_TEXT)
    assert tnative.available()
    got = tnative.load_obj_native(str(path))
    _same_mesh(got, tobj.load_obj(str(path), use_native=False),
               normals_exact=False)
    if jnative.available():
        _same_mesh(got, jnative.load_obj_native(str(path)),
                   normals_exact=False)
    _same_mesh(tobj.load_obj(str(path)), got)
    _same_mesh(tply.load_mesh(str(path)), got)
    plain = tmp_path / "mesh.dat"
    plain.write_text(OBJ_TEXT)
    _same_mesh(tply.load_mesh(str(plain)), got)
    corners = tmp_path / "c.obj"
    corners.write_text(OBJ_CORNERS)
    assert tnative.load_obj_native(str(corners)) is None
    from raypt.io import obj as jobj
    _same_mesh(tobj.load_obj(str(corners)),
               jobj.load_obj(str(corners), use_native=False))
    rng = np.random.default_rng(5)
    pos = rng.normal(size=(40, 3)).astype(np.float32)
    faces = rng.integers(0, 40, (60, 3))
    np.testing.assert_allclose(tnative.smooth_normals_native(pos, faces),
                               tobj.smooth_normals(pos, faces),
                               atol=NORMALS_ATOL)
    if jnative.available():
        np.testing.assert_allclose(
            tnative.smooth_normals_native(pos, faces),
            jnative.smooth_normals_native(pos, faces), atol=NORMALS_ATOL)


def test_ppm_npy_bytes(tmp_path):
    """write_ppm of float and uint8 images and write_npy write the JAX
    package's bytes; read_ppm reads them back."""
    rng = np.random.default_rng(1)
    img = rng.uniform(-0.1, 1.1, (5, 7, 3)).astype(np.float32)
    u8 = rng.integers(0, 256, (4, 3, 4), dtype=np.uint8)
    for name, a in (("f", img), ("u", u8)):
        pj, pt = tmp_path / f"{name}j.ppm", tmp_path / f"{name}t.ppm"
        jimage.write_ppm(str(pj), a)
        timage.write_ppm(str(pt), torch.from_numpy(a))
        assert pj.read_bytes() == pt.read_bytes()
        assert np.array_equal(timage.read_ppm(str(pt)),
                              jimage.read_ppm(str(pj)))
    jimage.write_npy(str(tmp_path / "j.npy"), img)
    timage.write_npy(str(tmp_path / "t.npy"), torch.from_numpy(img))
    assert (tmp_path / "j.npy").read_bytes() == (tmp_path / "t.npy").read_bytes()
    with pytest.raises(ValueError):
        (tmp_path / "bad.ppm").write_bytes(b"P3\n1 1\n255\n0 0 0")
        timage.read_ppm(str(tmp_path / "bad.ppm"))


def test_render_state_both_ways(tmp_path):
    """A render state written by either package loads in the other:
    accum bitwise, the frame index, and the key's two words."""
    rng = np.random.default_rng(2)
    acc = rng.uniform(size=(4, 6, 3)).astype(np.float32)
    jkey = jax.random.fold_in(jax.random.key(5), 7)
    words = np.asarray(jax.random.key_data(jkey))
    jck.save_render_state(str(tmp_path / "j.npz"), jnp.asarray(acc), 3, jkey)
    a, fi, k = tck.load_render_state(str(tmp_path / "j.npz"), "cpu")
    assert np.array_equal(a.numpy(), acc) and fi == 3
    assert k == Key(int(words[0]), int(words[1]))
    tck.save_render_state(str(tmp_path / "t.npz"), torch.from_numpy(acc), 4,
                          Key(int(words[0]), int(words[1])))
    a, fi, k = jck.load_render_state(str(tmp_path / "t.npz"))
    assert np.array_equal(np.asarray(a), acc) and fi == 4
    assert np.array_equal(np.asarray(jax.random.key_data(k)), words)
    assert (sorted(np.load(tmp_path / "j.npz").files)
            == sorted(np.load(tmp_path / "t.npz").files))


@pytest.mark.parametrize("lattice", [0, 3])
def test_scene_params_both_ways(lattice, tmp_path):
    """SceneParams saved by either package load in the other with the
    same npz keys, every leaf bitwise, and the step."""
    b = jscenes.triangle_ground()
    js = b.freeze()
    ts = scene_from_numpy(jax_leaves(js), "cpu")
    rng = np.random.default_rng(lattice)
    jp = JParams.init(js, lattice=lattice)
    jp = jax.tree_util.tree_map(
        lambda x: x + jnp.asarray(rng.normal(size=x.shape), x.dtype), jp)
    jck.save_pytree(str(tmp_path / "j.npz"), jp, step=9)
    tp, step = tck.load_pytree(str(tmp_path / "j.npz"),
                               SceneParams.init(ts, lattice=lattice))
    assert step == 9 and isinstance(tp, SceneParams)
    for name in FIELDS:
        jv = getattr(jp, name)
        if jv is None:
            assert getattr(tp, name) is None
        else:
            assert np.array_equal(getattr(tp, name).detach().numpy(),
                                  np.asarray(jv))
    tck.save_pytree(str(tmp_path / "t.npz"), tp, step=11, meta={"a": 1})
    back, step = jck.load_pytree(str(tmp_path / "t.npz"), jp)
    assert step == 11
    for x, y in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jp)):
        assert np.array_equal(np.asarray(x), np.asarray(y))
    tkeys = set(np.load(tmp_path / "t.npz").files) - {"__meta__"}
    assert tkeys == set(np.load(tmp_path / "j.npz").files)


def test_pytree_nested(tmp_path):
    """A dict / list / tuple tree: JAX path keys, a round trip in the
    port, a missing leaf raises."""
    tree = {"b": [torch.arange(3.0), (torch.ones(2, 2),)],
            "a": torch.tensor(5, dtype=torch.int32)}
    tck.save_pytree(str(tmp_path / "t.npz"), tree, step=2)
    jtree = {"b": [jnp.arange(3.0), (jnp.ones((2, 2)),)],
             "a": jnp.asarray(5, jnp.int32)}
    jck.save_pytree(str(tmp_path / "j.npz"), jtree, step=2)
    assert (set(np.load(tmp_path / "t.npz").files)
            == set(np.load(tmp_path / "j.npz").files))
    back, step = tck.load_pytree(str(tmp_path / "j.npz"), tree)
    assert step == 2 and torch.equal(back["a"], tree["a"])
    assert torch.equal(back["b"][1][0], tree["b"][1][0])
    assert isinstance(back["b"][1], tuple)
    with pytest.raises(KeyError):
        tck.load_pytree(str(tmp_path / "t.npz"), {"c": torch.zeros(1)})


def test_transforms():
    """rot_x/y/z, compose_matrix, transform_points / transform_dirs
    against the JAX package's, to M3_ATOL."""
    for a in (0.0, 0.3, -2.1, np.pi):
        for jf, tf in ((jm3.rot_x, tm3.rot_x), (jm3.rot_y, tm3.rot_y),
                       (jm3.rot_z, tm3.rot_z)):
            np.testing.assert_allclose(tf(a).numpy(), np.asarray(jf(a)),
                                       atol=M3_ATOL)
    rot = np.asarray(jm3.rot_y(0.7) @ jm3.rot_x(-0.2))
    t, sc = np.array([1.0, -2.0, 3.0]), np.array([2.0, 0.5, 1.5])
    jm = jm3.compose_matrix(jnp.asarray(t, jnp.float32), jnp.asarray(rot),
                            jnp.asarray(sc, jnp.float32))
    tm = tm3.compose_matrix(t, torch.from_numpy(rot), sc)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=M3_ATOL)
    pts = np.random.default_rng(0).normal(size=(5, 4, 3)).astype(np.float32)
    for jf, tf in ((jm3.transform_points, tm3.transform_points),
                   (jm3.transform_dirs, tm3.transform_dirs)):
        np.testing.assert_allclose(tf(tm, torch.from_numpy(pts)).numpy(),
                                   np.asarray(jf(jm, jnp.asarray(pts))),
                                   atol=M3_ATOL)


def _populate(b, jax_side):
    mod = jscene_mod if jax_side else tscene_mod
    m0 = b.add_material(mod.MaterialDef(albedo=(0.2, 0.4, 0.6),
                                        roughness=0.3))
    b.add_triangle((0, 0, 0), (1, 0, 0), (0, 1, 0), m0)
    b.add_sphere((0, 0, -3), 0.5, m0)
    b.add_mesh(np.eye(3, dtype=np.float32), np.eye(3, dtype=np.float32),
               np.array([[0, 1, 2]]), material=m0)


@pytest.mark.parametrize("pad", [False, True])
def test_freeze_pad_and_counters(pad):
    """freeze(pad=...) gives the JAX package's arrays; num_faces,
    num_vertices, num_spheres and the dirty flags follow it."""
    jb, tb = jscene_mod.SceneBuilder(), tscene_mod.SceneBuilder()
    assert int(tb.dirty) == int(jb.dirty)
    _populate(jb, True)
    _populate(tb, False)
    assert int(tb.dirty) == int(jb.dirty)
    assert ((tb.num_faces, tb.num_vertices, tb.num_spheres)
            == (jb.num_faces, jb.num_vertices, jb.num_spheres) == (2, 6, 1))
    js, ts = jb.freeze(pad=pad), tb.freeze("cpu", pad=pad)
    assert int(tb.dirty) == int(jb.dirty) == int(tscene_mod.DirtyFlag.SAMPLES)
    want = jax_leaves(js)
    for grp in ("materials", "spheres", "mesh"):
        obj = getattr(ts, grp)
        for name, v in vars(obj).items():
            assert np.array_equal(v.numpy(), want[f"{grp}.{name}"]), name
    tb.add_sphere((1, 1, 1), 0.1)
    jb.add_sphere((1, 1, 1), 0.1)
    assert int(tb.dirty) == int(jb.dirty)


def _env_cases():
    rng = np.random.default_rng(0)
    return {"cube": (rng.uniform(0, 2, (6, 8, 8, 3)).astype(np.float32), True),
            "equirect": (rng.uniform(0, 2, (16, 32, 3)).astype(np.float32),
                         False)}


@pytest.mark.parametrize("kind", ["cube", "equirect"])
def test_env_lod(kind):
    """build_mip_chain (whole and cut at 2 levels) and sample_env_lod
    with a per-ray and a scalar lod, against the JAX package's."""
    data, is_cube = _env_cases()[kind]
    for levels in (0, 2):
        jc = jenv.build_mip_chain(jnp.asarray(data), levels)
        tc = tenv.build_mip_chain(torch.from_numpy(data), levels)
        assert len(tc) == len(jc)
        for a, b in zip(jc, tc):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ENV_ATOL)
    rng = np.random.default_rng(1)
    d = rng.normal(size=(200, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    jc = jenv.build_mip_chain(jnp.asarray(data))
    tc = tenv.build_mip_chain(torch.from_numpy(data))
    for lod in (rng.uniform(-0.5, 6, 200).astype(np.float32), 1.5, 0.0):
        a = jenv.sample_env_lod(JEnv(data=jnp.asarray(data), is_cube=is_cube),
                                jc, jnp.asarray(d), jnp.asarray(lod))
        b = tenv.sample_env_lod(EnvMap(data=torch.from_numpy(data),
                                       is_cube=is_cube), tc,
                                torch.from_numpy(d), torch.as_tensor(lod))
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ENV_ATOL)


def test_cube_equirect():
    """equirect_to_cube and cube_to_equirect, default and given sizes,
    against the JAX package's."""
    cases = _env_cases()
    eq, cube = cases["equirect"][0], cases["cube"][0]
    for size in (0, 5):
        a = jenv.equirect_to_cube(jnp.asarray(eq), size)
        b = tenv.equirect_to_cube(torch.from_numpy(eq), size)
        assert b.shape == a.shape
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ENV_ATOL)
    for height in (0, 6):
        a = jenv.cube_to_equirect(jnp.asarray(cube), height)
        b = tenv.cube_to_equirect(torch.from_numpy(cube), height)
        assert b.shape == a.shape
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ENV_ATOL)


def _tiny_scene():
    """tests/test_debug.py's quad and sphere under a constant sky."""
    b = tscene_mod.SceneBuilder(env=EnvMap.constant((0.4, 0.5, 0.6)))
    m0 = b.add_material(tscene_mod.MaterialDef(albedo=(0.7, 0.6, 0.5)))
    b.add_quad((-2, -1, -6), (2, -1, -6), (2, -1, -2), (-2, -1, -2), m0)
    b.add_sphere((0, 0, -4), 0.8, m0)
    b.camera.viewport_width = b.camera.viewport_height = 16
    return b.freeze("cpu")


CFG = RenderConfig(width=16, height=16, samples_per_pixel=1, num_bounces=3,
                   backend="bruteforce")


def test_checked_render_clean_scene_passes():
    """No check fails on a clean scene, and the image is render_frame's,
    bitwise."""
    scene = _tiny_scene()
    err, img = checked_render_frame(scene, CFG, key(0), throw=False)
    assert err.get() is None
    assert torch.isfinite(img).all()
    assert torch.equal(img, render_frame(scene, CFG, key(0)))


def test_checked_render_catches_nan_albedo():
    scene = _tiny_scene()
    alb = scene.materials.albedo.clone()
    alb[0, 0] = float("nan")
    bad = scene.replace(materials=scene.materials.replace(albedo=alb))
    err, _ = checked_render_frame(bad, CFG, key(0), throw=False)
    msg = err.get()
    assert msg is not None and "nan" in msg.lower()
    with pytest.raises(RenderCheckError):
        checked_render_frame(bad, CFG, key(0), throw=True)


@pytest.mark.parametrize("backend", ["bvh", "bvh4"])
def test_checked_render_catches_nan_vertex_bvh(backend):
    """A poisoned vertex flows through the tree walks; the check
    surfaces it."""
    b = tscene_mod.SceneBuilder(env=EnvMap.constant((0.3, 0.3, 0.3)))
    m0 = b.add_material(tscene_mod.MaterialDef(albedo=(0.6, 0.6, 0.6)))
    rngv = np.random.default_rng(0)
    for _ in range(80):
        base = rngv.uniform(-2, 2, 3) - [0, 0, 5]
        b.add_triangle(base, base + rngv.uniform(-1, 1, 3),
                       base + rngv.uniform(-1, 1, 3), m0)
    b.camera.viewport_width = b.camera.viewport_height = 8
    scene = b.freeze("cpu")
    pos = scene.mesh.positions.clone()
    pos[0, 0] = float("nan")
    bad = scene.replace(mesh=scene.mesh.replace(positions=pos))
    cfg = RenderConfig(width=8, height=8, samples_per_pixel=1, num_bounces=2,
                       backend=backend)
    err, _ = checked_render_frame(bad, cfg, key(0), throw=False)
    assert err.get() is not None and "nan" in err.get()


def test_checked_render_catches_bad_ids(monkeypatch):
    """A finder whose sphere ids leave [-1, spheres) fails the index
    check, with the index in the message."""
    from raypt_torch.accel.traverse import find_closest_bruteforce
    from raypt_torch.app import debug

    def broken(scene, ro, rd, active=None):
        ids = find_closest_bruteforce(scene, ro, rd, active)
        ids.sphere = torch.where(ids.sphere < 0, -5, ids.sphere)
        return ids

    monkeypatch.setattr(debug, "make_finder", lambda s, c, a=None: broken)
    err, _ = checked_render_frame(_tiny_scene(), CFG, key(0), throw=False)
    assert "index -5 out of range" in err.get()
