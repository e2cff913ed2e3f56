"""The port's native sim engine against its python engine and the JAX
package's.

On ``dasa_tpu_torch/testing.py``'s synthetic world (two scans of 24
nodes): ``dasa_tpu_torch/sim/csim.py``'s engine, built by ``make`` from the
port's own copy of ``dasasim.cpp`` into ``dasa_tpu_torch/_build/``, must
give the graphs, shortest paths, candidates and observation streams of the
port's python engine and of ``dasa_tpu.sim.engine`` at the tolerances of
``tests/test_native_sim.py`` (distances rel 1e-5, angles 1e-5 / 1e-4,
observations 1e-4; first hops may differ only between equal-length
paths).  ``R2REnv``'s ``auto`` picks it, ``native`` raises when it cannot
be built, and a host-rollout evaluation takes the same trajectories under
both backends.
"""

import os

import numpy as np
import pytest
import torch

from dasa_tpu.data.features import FeatureDB as JaxFeatureDB
from dasa_tpu.env import R2REnv as JaxEnv
from dasa_tpu.sim.engine import compute_pano_candidates as jax_candidates
from dasa_tpu.sim.graph import load_scan_graph as jax_load_scan_graph
from dasa_tpu_torch.agents import Seq2SeqAgent
from dasa_tpu_torch.config import Config
from dasa_tpu_torch.data.datasets import (
    expand_instructions,
    load_datasets,
    make_synthetic_task,
)
from dasa_tpu_torch.data.features import FeatureDB
from dasa_tpu_torch.env import R2REnv
from dasa_tpu_torch.sim import csim
from dasa_tpu_torch.sim.engine import compute_pano_candidates
from dasa_tpu_torch.sim.graph import load_scan_graph
from dasa_tpu_torch.testing import torch_threads, write_synthetic_connectivity
from dasa_tpu_torch.utils import Tokenizer, build_vocab

SCANS = ("synthA", "synthB")
L = 24
OBS_INT = ("feat_row", "view_index", "cand_point_id", "cand_nbr_ix",
           "cand_n", "teacher", "back_teacher")
OBS_FLOAT = ("heading", "elevation", "cand_heading", "cand_elevation",
             "distance", "progress")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_native_world")
    conn, data = str(root / "connectivity"), str(root / "task")
    write_synthetic_connectivity(conn, SCANS, n_nodes=24, seed=0)
    make_synthetic_task(data, SCANS[:1], SCANS[1:], n_train=8, n_val=4,
                        connectivity_dir=conn)
    vocab = build_vocab(load_datasets(["train"], data), min_count=1)
    return conn, data, Tokenizer(vocab, encoding_length=L)


@pytest.fixture(scope="module")
def engine(world):
    conn = world[0]
    eng = csim.NativeEngine(k_max=16)
    for scan in SCANS:
        eng.load_scan(scan, conn)
    return eng


def items(world, split):
    _conn, data, tok = world
    return expand_instructions(load_datasets([split], data), tok,
                               max_input=L)


def test_library_is_the_ports_own_build():
    lib = csim.load_library()
    path = os.path.realpath(lib._name)
    assert path == os.path.realpath(str(csim.library_path()))
    assert os.path.dirname(path) == os.path.realpath(str(csim.BUILD_DIR))
    assert os.sep + os.path.join("dasa_tpu_torch", "_build") in path
    assert os.path.exists(path)


def test_graph_and_paths_match(engine, world):
    conn = world[0]
    for si, scan in enumerate(SCANS):
        g = load_scan_graph(scan, conn)
        g.compute_shortest_paths()
        jg = jax_load_scan_graph(scan, conn)
        jg.compute_shortest_paths()
        n = engine.num_nodes(si)
        assert n == g.num_nodes == jg.num_nodes
        for i in range(n):
            assert engine.node_id(si, i) == g.ids[i] == jg.ids[i]
            assert engine.node_index(si, g.ids[i]) == i
        inc = np.nonzero(g.included)[0]
        w = g.edge_lengths()
        for a in inc:
            for b in inc:
                a, b = int(a), int(b)
                d_c = engine.distance(si, a, b)
                np.testing.assert_allclose(g.dist[a, b], jg.dist[a, b],
                                           rtol=1e-12)
                if np.isinf(g.dist[a, b]):
                    assert np.isinf(d_c)
                    continue
                assert d_c == pytest.approx(g.dist[a, b], rel=1e-5)
                if a != b:
                    # first hops may differ only between equal-length paths
                    hop = engine.next_hop(si, a, b)
                    assert g.nav_adjacency()[a, hop]
                    assert w[a, hop] + g.dist[hop, b] == pytest.approx(
                        g.dist[a, b], rel=1e-5)
                    path = engine.shortest_path(si, a, b)
                    assert path[0] == a and path[-1] == b


def test_candidates_match(engine, world):
    conn = world[0]
    for si, scan in enumerate(SCANS):
        g = load_scan_graph(scan, conn)
        jg = jax_load_scan_graph(scan, conn)
        for node in np.nonzero(g.included)[0]:
            node = int(node)
            for ref in (compute_pano_candidates(g, node),
                        jax_candidates(jg, node)):
                nbr, point, nh, elev, rd = engine.candidates(si, node)
                np.testing.assert_array_equal(nbr, ref.nbr_ix)
                np.testing.assert_array_equal(point, ref.point_id)
                np.testing.assert_allclose(nh, ref.normalized_heading,
                                           atol=1e-5)
                np.testing.assert_allclose(elev, ref.elevation, atol=1e-5)
                np.testing.assert_allclose(rd, ref.rel_distance, atol=1e-4)


@pytest.mark.parametrize("split", ["train", "val_unseen"])
def test_env_obs_streams_identical(world, split):
    """The same episodes through the port's native and python envs and the
    JAX package's python env: every observation field of a teacher walk,
    and the trajectories."""
    conn = world[0]
    kw = dict(batch_size=4, connectivity_dir=conn, max_candidates=16,
              max_input=L, seed=3)
    feat = FeatureDB.synthetic(SCANS, conn, dim=16)
    envs = [R2REnv(feat, items(world, split), backend="native", **kw),
            R2REnv(feat, items(world, split), backend="python", **kw),
            JaxEnv(JaxFeatureDB.synthetic(SCANS, conn, dim=16),
                   items(world, split), backend="python", **kw)]
    assert [e.backend for e in envs] == ["native", "python", "python"]
    for _episode in range(3):
        obs = [e.reset() for e in envs]
        trajs = [[[t] for t in e.state_tuples()] for e in envs]
        for _step in range(12):
            for o in obs[1:]:
                for f in OBS_INT:
                    np.testing.assert_array_equal(
                        getattr(obs[0], f), getattr(o, f), err_msg=f)
                for f in OBS_FLOAT:
                    np.testing.assert_allclose(
                        getattr(obs[0], f), getattr(o, f), atol=1e-4,
                        err_msg=f)
            teacher = obs[0].teacher
            actions = np.where(teacher < obs[0].cand_n, teacher, -1)
            if (actions < 0).all():
                break
            obs = [e.step(actions, t) for e, t in zip(envs, trajs)]
        for other in trajs[1:]:
            for tn, to in zip(trajs[0], other):
                assert [v for v, _, _ in tn] == [v for v, _, _ in to]
                np.testing.assert_allclose([(h, e) for _, h, e in tn],
                                           [(h, e) for _, h, e in to],
                                           atol=1e-6)


def test_auto_picks_native_and_native_raises(world, monkeypatch, capsys):
    conn = world[0]
    feat = FeatureDB.synthetic(SCANS, conn, dim=16)
    kw = dict(batch_size=2, connectivity_dir=conn, max_input=L)
    assert R2REnv(feat, items(world, "train"), **kw).backend == "native"

    def broken():
        raise RuntimeError("building the native sim engine failed (test)")

    monkeypatch.setattr(csim, "_LIB", None)
    monkeypatch.setattr(csim, "build", broken)
    with pytest.raises(RuntimeError, match="native sim engine failed"):
        R2REnv(feat, items(world, "train"), backend="native", **kw)
    env = R2REnv(feat, items(world, "train"), backend="auto", name="fb",
                 **kw)
    assert env.backend == "python"
    assert "running the python engine" in capsys.readouterr().out
    with pytest.raises(ValueError):
        R2REnv(feat, items(world, "train"), backend="opengl", **kw)


def test_host_evaluation_equal_under_both_backends(world):
    """The host act / replay rollout's argmax evaluation of a split (the
    env steps every move) under the native and the python engine: the
    same trajectories, and the same SR / SPL from ``Evaluation``."""
    from dasa_tpu_torch.train.evaluation import Evaluation

    conn, data, tok = world
    cfg = Config(angle_feat_size=8, feature_size=24, max_input=L, rnn_dim=32,
                 wemb=16, aemb=8, critic_dim=32, batch_size=2, max_action=6,
                 max_candidates=16, device_rollout="never",
                 connectivity_dir=conn, data_dir=data)
    feat = FeatureDB.synthetic(SCANS, conn, dim=24)
    out = {}
    for backend in ("native", "python"):
        env = R2REnv(feat, items(world, "val_unseen"), batch_size=2,
                     connectivity_dir=conn, max_candidates=16, max_input=L,
                     backend=backend)
        agent = Seq2SeqAgent(cfg, env, feat, vocab_size=len(tok),
                             device="cpu")
        results = agent.test(feedback="argmax")
        summary, _ = Evaluation(load_datasets(["val_unseen"], data), conn,
                                splits=["val_unseen"]).score(results)
        out[backend] = ({r["instr_id"]: r["trajectory"] for r in results},
                        summary)
        assert len(results) == env.size()
    assert out["native"][0].keys() == out["python"][0].keys()
    for key, traj in out["python"][0].items():
        got = out["native"][0][key]
        assert [v for v, _, _ in got] == [v for v, _, _ in traj], key
        np.testing.assert_allclose([t[1:] for t in got],
                                   [t[1:] for t in traj], atol=1e-6)
    for key in ("success_rate", "spl", "nav_error"):
        assert out["native"][1][key] == pytest.approx(out["python"][1][key],
                                                      abs=1e-6)
    assert torch.get_num_threads() == 1
