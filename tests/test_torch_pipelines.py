"""The port's offline pipeline against the JAX package's.

- ``models/resnet.py`` against ``dasa_tpu.models.resnet`` with the JAX
  module's variables carried over by ``resnet_state_dict_from_jax`` (random
  BatchNorm statistics and affine terms, so no BatchNorm is the identity),
  in f32 on the CPU: stages (1, 1, 1, 1) at 32 x 32 and ``resnet50`` at
  64 x 64, within rtol 1e-4 of the pooled features' scale;
- ``resnet152``'s map consumes every flax leaf, at the port's shapes;
- ``ViewFeaturizer`` and ``featurize_views`` against the JAX ones (both
  monkeypatched to the one-block ResNet, whose network the first case
  holds), with a last chunk shorter than the batch, and the npy pair read
  back by the port's ``FeatureDB``;
- ``pipelines/enable_depth.py`` and ``sim/render.py``, numpy copies, on
  seeded inputs against JAX's: equal to the bit; the render regression
  harness on a spec and golden PNGs this test writes (the reference's
  spec is not in the repository).
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dasa_tpu.pipelines.depth_features as jax_features
import dasa_tpu.pipelines.enable_depth as jax_depth
import dasa_tpu.sim.render as jax_render
import dasa_tpu_torch.pipelines.depth_features as port_features
import dasa_tpu_torch.pipelines.enable_depth as port_depth
import dasa_tpu_torch.sim.render as port_render
from dasa_tpu.models import resnet as jax_resnet
from dasa_tpu_torch.data.features import load_feature_db
from dasa_tpu_torch.models import resnet
from dasa_tpu_torch.testing import torch_threads, write_synthetic_connectivity
from dasa_tpu_torch.utils.jax_params import resnet_state_dict_from_jax

RTOL = 1e-4
TINY = (1, 1, 1, 1)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


def jax_variables(model, size: int, seed: int = 0):
    """The JAX module's variables at a ``size`` x ``size`` input, with
    seeded BatchNorm statistics, scales and biases."""
    x = jnp.zeros((1, size, size, 3), jnp.float32)
    variables = jax.tree_util.tree_map(
        np.asarray, model.init(jax.random.PRNGKey(seed), x))
    rng = np.random.default_rng(seed + 1)

    def perturb(tree):
        out = {}
        for key, val in tree.items():
            if isinstance(val, dict):
                out[key] = perturb(val)
            elif key in ("scale", "var"):
                out[key] = rng.uniform(0.5, 1.5, val.shape).astype(np.float32)
            elif key in ("bias", "mean"):
                out[key] = rng.normal(0, 0.1, val.shape).astype(np.float32)
            else:
                out[key] = val
        return out

    return {coll: perturb(dict(tree)) for coll, tree in variables.items()}


def port_model(stages, variables):
    model = resnet.ResNet(stages)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in
                           resnet_state_dict_from_jax(variables).items()})
    return model


@pytest.mark.parametrize("stages,size", [(TINY, 32), ((3, 4, 6, 3), 64)])
def test_resnet_matches_jax(stages, size):
    jmodel = jax_resnet.ResNet(stages)
    variables = jax_variables(jmodel, size)
    x = np.random.default_rng(2).random((2, size, size, 3), np.float32)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = port_model(stages, variables)(torch.as_tensor(x)).numpy()
    assert got.shape == want.shape == (2, 2048) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


def test_resnet152_map_consumes_every_leaf():
    shapes = jax.eval_shape(
        jax_resnet.resnet152().init, jax.random.PRNGKey(0),
        jnp.zeros((1, 32, 32, 3), jnp.float32))
    variables = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    n_leaves = len(jax.tree_util.tree_leaves(variables))
    state = resnet_state_dict_from_jax(variables)
    port = resnet.resnet152().state_dict()
    assert state.keys() == port.keys()
    # every leaf mapped once; the port adds num_batches_tracked per norm
    assert len(state) == n_leaves + sum(k.endswith("num_batches_tracked")
                                        for k in port)
    for key, val in port.items():
        assert state[key].shape == tuple(val.shape), key
    with pytest.raises(KeyError, match="unmapped"):
        resnet_state_dict_from_jax(
            {"params": {"fc": {"kernel": np.zeros((2, 2))}},
             "batch_stats": {}})


@pytest.fixture
def tiny_featurizers(monkeypatch):
    """The JAX and port featurizers on the one-block ResNet, one set of
    weights."""
    monkeypatch.setattr(jax_features, "resnet152",
                        lambda dtype: jax_resnet.ResNet(TINY, dtype))
    monkeypatch.setattr(port_features, "resnet152",
                        lambda: resnet.ResNet(TINY))
    variables = jax_variables(jax_resnet.ResNet(TINY), 32, seed=3)
    jfeat = jax_features.ViewFeaturizer(
        params=variables, batch_size=3, image_size=(24, 32),
        dtype=jnp.float32)
    feat = port_features.ViewFeaturizer(
        resnet_state_dict_from_jax(variables), batch_size=3,
        image_size=(24, 32), device="cpu")
    return jfeat, feat


def test_featurizer_matches_jax(tiny_featurizers):
    jfeat, feat = tiny_featurizers
    rng = np.random.default_rng(4)
    depth = rng.uniform(0, 1, (5, 24, 32)).astype(np.float32)  # 3 + 2 rows
    rgb = rng.uniform(0, 1, (4, 24, 32, 3)).astype(np.float32)
    for images in (depth, rgb):
        want = jfeat(images)
        got = feat(images)
        assert got.shape == (len(images), 2048)
        np.testing.assert_allclose(got, want, rtol=RTOL,
                                   atol=RTOL * np.abs(want).max())
    img = rng.uniform(0, 4000, (16, 20)).astype(np.float32)
    np.testing.assert_array_equal(port_features.normalize_depth(img),
                                  jax_features.normalize_depth(img))


def test_featurize_views_npy_pair_read_by_feature_db(tiny_featurizers,
                                                     tmp_path):
    jfeat, feat = tiny_featurizers
    conn = str(tmp_path / "connectivity")
    write_synthetic_connectivity(conn, ["synthA"], n_nodes=4, seed=0)
    with open(f"{conn}/synthA_connectivity.json") as f:
        vps = [n["image_id"] for n in json.load(f)]
    rng = np.random.default_rng(5)
    views = {vp: rng.uniform(0, 3000, (4, 24, 32)).astype(np.float32)
             for vp in vps}
    ids = [("synthA", vp) for vp in vps]

    def load(scan, vp):
        return views[vp]

    want = jax_features.featurize_views(ids, load, str(tmp_path / "jax"),
                                        featurizer=jfeat, views=4)
    prefix = str(tmp_path / "out" / "depth")
    got = port_features.featurize_views(ids, load, prefix, featurizer=feat,
                                        views=4)
    assert got.shape == (len(vps), 4, 2048)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())
    np.testing.assert_array_equal(np.load(prefix + "-index.npy"),
                                  np.load(str(tmp_path / "jax-index.npy")))
    db = load_feature_db(prefix + ".npy", ["synthA"], conn, dim=2048)
    for i, vp in enumerate(vps):
        np.testing.assert_array_equal(db.get("synthA", vp), got[i])


def test_featurizer_command(tiny_featurizers, tmp_path):
    """``python -m dasa_tpu_torch.pipelines.depth_features`` over a
    directory of view stacks."""
    _jfeat, feat = tiny_featurizers
    views = tmp_path / "views"
    views.mkdir()
    rng = np.random.default_rng(6)
    stacks = {}
    for vp in ("vp0", "vp1"):
        stacks[vp] = rng.uniform(0, 9, (36, 24, 32)).astype(np.float32)
        np.save(views / f"synthA_{vp}.npy", stacks[vp])
    torch.save({k: v for k, v in feat.model.state_dict().items()},
               tmp_path / "weights.pt")
    port_features.main(["--views_dir", str(views), "--out",
                        str(tmp_path / "feat"), "--weights",
                        str(tmp_path / "weights.pt"), "--batch_size", "36",
                        "--device", "cpu"])
    values = np.load(tmp_path / "feat.npy")
    assert list(np.load(tmp_path / "feat-index.npy")) == ["synthA_vp0",
                                                          "synthA_vp1"]
    norm = np.stack([port_features.normalize_depth(v)
                     for v in stacks["vp1"]])
    np.testing.assert_allclose(values[1], feat(norm), rtol=1e-6, atol=1e-6)


def test_enable_depth_matches_jax():
    rng = np.random.default_rng(7)
    for name in ("intrinsic_matrix",):
        np.testing.assert_array_equal(getattr(port_depth, name)(24, 16),
                                      getattr(jax_depth, name)(24, 16))
    k = port_depth.intrinsic_matrix(16, 12)
    depth = rng.uniform(1, 5, (12, 16))
    np.testing.assert_array_equal(
        port_depth.z_to_euclid(np.linalg.inv(k), depth),
        jax_depth.z_to_euclid(np.linalg.inv(k), depth))
    h = np.eye(3) + rng.normal(0, 0.05, (3, 3))
    for nearest in (True, False):
        for a, b in zip(port_depth.warp_homography(depth, h, (10, 14),
                                                   nearest),
                        jax_depth.warp_homography(depth, h, (10, 14),
                                                  nearest)):
            np.testing.assert_array_equal(a, b)
    holes = depth.copy()
    holes[rng.random(holes.shape) < 0.3] = 0
    np.testing.assert_array_equal(port_depth.fill_holes(holes),
                                  jax_depth.fill_holes(holes))
    for a, b in zip(port_depth.CUBE_FACE_ROTATIONS,
                    jax_depth.CUBE_FACE_ROTATIONS):
        np.testing.assert_array_equal(a, b)
    cams = {}
    for i, yaw in enumerate((0.0, math.pi / 2, math.pi)):
        rot = np.array([[math.cos(yaw), 0, math.sin(yaw)], [0, 1, 0],
                        [-math.sin(yaw), 0, math.cos(yaw)]])
        pose = np.eye(4)
        pose[:3, :3] = rot
        cams[f"cam{i}"] = (rng.uniform(1, 6, (16, 16)), k, pose)
    args = ({n: c[0] for n, c in cams.items()},
            {n: port_depth.intrinsic_matrix(16, 16) for n in cams},
            {n: c[2] for n, c in cams.items()}, np.eye(3))
    kw = dict(face_size=16, out_size=8)
    for a, b in zip(port_depth.depth_to_skybox_faces(*args, **kw),
                    jax_depth.depth_to_skybox_faces(*args, **kw)):
        np.testing.assert_array_equal(a, b)


def test_render_matches_jax():
    rng = np.random.default_rng(8)
    faces = [rng.uniform(0, 255, (16, 16, 3)) for _ in range(6)]
    for heading, elevation in ((0.0, 0.0), (1.3, 0.4), (4.0, -0.5)):
        np.testing.assert_array_equal(
            port_render.camera_rays(12, 9, heading, elevation, 1.0),
            jax_render.camera_rays(12, 9, heading, elevation, 1.0))
        np.testing.assert_array_equal(
            port_render.render_view(faces, heading, elevation, 20, 14),
            jax_render.render_view(faces, heading, elevation, 20, 14))
    np.testing.assert_array_equal(
        port_render.render_panorama(faces, 10, 8),
        jax_render.render_panorama(faces, 10, 8))


def test_render_regression_on_written_goldens(tmp_path):
    """The golden-image harness (src/test/main.cpp:302-338) on a spec and
    goldens this test writes from the JAX renderer: the port's renders
    pass at error 0, a shifted golden fails the 0.15 gate."""
    from PIL import Image

    rng = np.random.default_rng(9)
    skyboxes = {}

    def faces_for(scan, vp):
        if (scan, vp) not in skyboxes:
            skyboxes[scan, vp] = [rng.integers(0, 256, (32, 32, 3)).astype(
                np.float64) for _ in range(6)]
        return skyboxes[scan, vp]

    cases = [{"scanId": "synthA", "viewpointId": f"vp{i}",
              "heading": 0.9 * i, "elevation": 0.2 * (i - 1),
              "reference_image": f"synthA_vp{i}_{i}.png"} for i in range(3)]
    spec_path = tmp_path / "rendertest_spec.json"
    spec_path.write_text(json.dumps(cases))
    spec = port_render.load_render_spec(str(spec_path))
    assert spec == jax_render.load_render_spec(str(spec_path))
    golden = tmp_path / "goldens"
    golden.mkdir()
    for case in spec:
        img = jax_render.render_view(faces_for(case["scan"],
                                               case["viewpoint"]),
                                     case["heading"], case["elevation"],
                                     64, 48)
        Image.fromarray(np.clip(np.round(img), 0, 255).astype(
            np.uint8)).save(golden / case["reference_image"])
    out = tmp_path / "sim_imgs"
    results = port_render.render_regression(spec, faces_for, str(golden),
                                            out_dir=str(out), width=64,
                                            height=48)
    assert all(r["passed"] and r["error"] == 0.0 for r in results), results
    assert (out / spec[0]["reference_image"]).exists()
    bad = np.asarray(Image.open(golden / spec[1]["reference_image"]))
    Image.fromarray(np.clip(bad.astype(np.int64) + 32, 0, 255).astype(
        np.uint8)).save(golden / spec[1]["reference_image"])
    results = port_render.render_regression(spec, faces_for, str(golden),
                                            width=64, height=48)
    assert [r["passed"] for r in results] == [True, False, True]
