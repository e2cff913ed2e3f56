"""The PyTorch port's argmax evaluation slice against the JAX package.

On a synthetic 2-scan world (written to a temp dir in the R2R
connectivity format), the JAX ``Seq2SeqAgent`` and the port's agent run
the Dic / channel-AdaIN / shift-5 listener of tests/test_device_env.py
with the same weights (carried with ``policy_state_dict_from_jax``),
under ``use_pallas`` ``never`` and ``always``, in f32 on the CPU: the
argmax trajectories must be equal, the first-step logits allclose and
the ``Evaluation.score`` summaries the same.  Guards: the port never
loads JAX and imports nothing of ``dasa_tpu``, and its parameter names
round-trip through the JAX package's own torch-checkpoint translators.
"""

import ast
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dasa_tpu.agents import Seq2SeqAgent as JaxAgent
from dasa_tpu.agents.seq2seq import make_step_inputs as jax_step_inputs
from dasa_tpu.config import Config as JaxConfig
from dasa_tpu.data.features import FeatureDB as JaxFeatureDB
from dasa_tpu.env import R2REnv as JaxEnv
from dasa_tpu.env.device_env import device_obs as jax_device_obs
from dasa_tpu.env.device_env import episode_inputs as jax_episode_inputs
from dasa_tpu.train.evaluation import Evaluation as JaxEvaluation
from dasa_tpu.utils import torch_import
from dasa_tpu_torch.agents import Seq2SeqAgent
from dasa_tpu_torch.config import Config
from dasa_tpu_torch.data.datasets import (
    expand_instructions,
    load_datasets,
    make_synthetic_task,
)
from dasa_tpu_torch.data.features import FeatureDB
from dasa_tpu_torch.env import R2REnv
from dasa_tpu_torch.testing import write_synthetic_connectivity
from dasa_tpu_torch.train.evaluation import Evaluation
from dasa_tpu_torch.utils import Tokenizer, build_vocab
from dasa_tpu_torch.utils.jax_params import (
    flatten_params,
    policy_state_dict_from_jax,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCANS = ("synthA", "synthB")
DIM = 24
L = 24
# tests/test_device_env.py:34-43 widths, with the Dic/channel/shift-5
# policy of :151-153
CFG = dict(
    rnn_dim=32, wemb=16, aemb=8, critic_dim=32, angle_feat_size=8,
    feature_size=DIM, max_input=L, max_candidates=16, max_action=5,
    batch_size=2, d_enc_hidden_size=16, d_hidden_size=32, d_vl_layers=1,
    d_la_layers=1, encoder_type="Dic", include_vision=True,
    adain_type="channel", ab_type="a", a_type="sigmoid", use_shift=True,
    shift_kernel_size=5)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_world")
    conn, data = str(root / "connectivity"), str(root / "task")
    write_synthetic_connectivity(conn, SCANS, n_nodes=24, seed=0)
    make_synthetic_task(data, SCANS[:1], SCANS[1:], n_train=4, n_val=2,
                        connectivity_dir=conn)
    vocab = build_vocab(load_datasets(["train"], data), min_count=1)
    return conn, data, Tokenizer(vocab, encoding_length=L)


def _items(world, split):
    conn, data, tok = world
    raw = load_datasets([split], data)
    return raw, expand_instructions(raw, tok, max_input=L)


def make_pair(world, use_pallas, split="val_seen"):
    """JAX agent and port agent over the same split, same weights."""
    conn, data, tok = world
    raw, items = _items(world, split)
    jcfg = JaxConfig(**CFG, use_pallas=use_pallas, connectivity_dir=conn)
    jfeat = JaxFeatureDB.synthetic(SCANS, conn, dim=DIM)
    jdepth = JaxFeatureDB.synthetic(SCANS, conn, dim=DIM, salt=7)
    jenv = JaxEnv(jfeat, items, batch_size=2, connectivity_dir=conn,
                  max_candidates=16, max_input=L, depth_db=jdepth)
    jagent = JaxAgent(jcfg, jenv, jfeat, depth_db=jdepth,
                      vocab_size=len(tok), rng_seed=11)

    cfg = Config(**CFG, use_pallas=use_pallas, connectivity_dir=conn)
    feat = FeatureDB.synthetic(SCANS, conn, dim=DIM)
    depth = FeatureDB.synthetic(SCANS, conn, dim=DIM, salt=7)
    env = R2REnv(feat, items, batch_size=2, connectivity_dir=conn,
                 max_candidates=16, max_input=L, depth_db=depth)
    agent = Seq2SeqAgent(cfg, env, feat, depth_db=depth, device="cpu")
    agent.load_jax_params(jax.tree_util.tree_map(np.asarray, jagent.params))
    return jagent, agent, raw


def jax_first_step_logits(agent):
    """The JAX policy's masked first-step logits of the env's next batch."""
    env, cfg = agent.env, agent.cfg
    env.reset()
    dev = agent._device_env_tables()
    ep = {k: jnp.asarray(v) for k, v in jax_episode_inputs(env, dev).items()}
    arrays = dev.arrays()
    goal = ep["goal"]
    total = arrays[6][ep["node0"], goal - arrays[8][goal]]
    sobs = jax_device_obs(arrays, ep["node0"], ep["view0"], goal,
                          ep["start"], total, cfg.max_candidates)
    inputs = jax_step_inputs(cfg, agent.tables, sobs)
    static = env._static
    logit, _value = agent.policy.apply(
        agent.params, jnp.asarray(static["instr"]),
        jnp.asarray(~static["pad_mask"]), jnp.asarray(static["seq_len"]),
        inputs)
    return np.asarray(jnp.where(sobs["logit_mask"], -1e9, logit))


@pytest.mark.parametrize("use_pallas", ["never", "always"])
def test_argmax_eval_matches_jax(world, use_pallas):
    jagent, agent, raw = make_pair(world, use_pallas)
    jagent.env.reset_epoch()
    agent.env.reset_epoch()
    np.testing.assert_allclose(agent.first_step_logits().numpy(),
                               jax_first_step_logits(jagent),
                               atol=1e-5, rtol=1e-5)

    j_res = jagent.test(feedback="argmax")
    t_res = agent.test(feedback="argmax")
    j_traj = {r["instr_id"]: r["trajectory"] for r in j_res}
    t_traj = {r["instr_id"]: r["trajectory"] for r in t_res}
    assert t_traj.keys() == j_traj.keys()
    for iid, traj in j_traj.items():
        assert [p[0] for p in t_traj[iid]] == [p[0] for p in traj], iid
        np.testing.assert_allclose([p[1:] for p in t_traj[iid]],
                                   [p[1:] for p in traj], atol=1e-9)
    assert agent.total_env_steps == jagent.total_env_steps

    conn = world[0]
    j_sum, _ = JaxEvaluation(raw, conn, splits=["val_seen"]).score(j_res)
    t_sum, _ = Evaluation(raw, conn, splits=["val_seen"]).score(t_res)
    assert t_sum.keys() == j_sum.keys()
    for key in j_sum:
        np.testing.assert_allclose(t_sum[key], j_sum[key], rtol=1e-12)


def test_valid_runs_both_splits_on_cpu(world):
    """The validlistener entry point end to end on the port."""
    from dasa_tpu_torch.train.trainer import valid

    conn, data, _tok = world
    cfg = Config(**CFG, data_dir=data, connectivity_dir=conn,
                 use_pallas="always")
    out = valid(cfg, device="cpu")
    assert set(out) == {"val_seen", "val_unseen"}
    for summary in out.values():
        assert 0.0 <= summary["success_rate"] <= 1.0
        assert np.isfinite(summary["nav_error"])


def test_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from dasa_tpu_torch.utils.device import resolve_device

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    assert resolve_device("cpu").type == "cpu"


def test_import_does_not_load_jax_or_the_jax_package():
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import dasa_tpu_torch, dasa_tpu_torch.ops, dasa_tpu_torch.testing\n"
        "import dasa_tpu_torch.train.trainer, dasa_tpu_torch.utils.jax_params\n"
        "import dasa_tpu_torch.cli, dasa_tpu_torch.train.optim\n"
        "import dasa_tpu_torch.train.metrics, dasa_tpu_torch.pretrain.trainer\n"
        "import dasa_tpu_torch.utils.flax_msgpack\n"
        "import dasa_tpu_torch.utils.pretrain_load\n"
        "import dasa_tpu_torch.utils.torch_import\n"
        "import dasa_tpu_torch.data.ndh, dasa_tpu_torch.data.semantic\n"
        "from dasa_tpu_torch.data.btokenizer import BTokenizer\n"
        "import dasa_tpu_torch.parallel, dasa_tpu_torch.parallel.distributed\n"
        "import dasa_tpu_torch.models.resnet, dasa_tpu_torch.pipelines\n"
        "import dasa_tpu_torch.pipelines.enable_depth\n"
        "import dasa_tpu_torch.sim.render, dasa_tpu_torch.sim.csim\n"
        "import dasa_tpu_torch.scripts.make_task\n"
        "import dasa_tpu_torch.scripts.make_mini_dataset\n"
        "import dasa_tpu_torch.scripts.random_agent\n"
        "import dasa_tpu_torch.scripts.interactive_agent\n"
        "import dasa_tpu_torch.scripts.plot_curves\n"
        "import dasa_tpu_torch.scripts.make_aug_paths\n"
        "import dasa_tpu_torch.scripts.check_real_data\n"
        "import dasa_tpu_torch.scripts.stream_quality_ab\n"
        "bad = [m for m in set(sys.modules) - before if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'optax', 'msgpack', 'dasa_tpu')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True)


def test_port_sources_import_nothing_of_jax_or_the_jax_package():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for base, _dirs, names in os.walk(os.path.join(REPO, "dasa_tpu_torch")):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    banned = {"jax", "jaxlib", "flax", "optax", "msgpack", "dasa_tpu"}
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                assert mod.split(".")[0] not in banned, (path, mod)


def test_state_dict_round_trips_through_jax_translators(world):
    """The port's names are the reference's r2r_src names: the JAX
    package's own torch-checkpoint translators map the port's state_dict
    back onto the JAX params exactly."""
    jagent, agent, _raw = make_pair(world, "never")
    params = jax.tree_util.tree_map(np.asarray, jagent.params)["params"]
    state = {k: v.numpy() for k, v in agent.policy.state_dict().items()}
    parts = {
        "encoder": torch_import.translate_dic_encoder(state, "encoder."),
        "decoder": torch_import.translate_battn_decoder(state, "decoder."),
        "critic": torch_import.translate_critic(state, "critic."),
        "adain": torch_import.translate_linear(state, "adain.a_fc", "a_fc"),
    }
    for name, translated in parts.items():
        zeros = jax.tree_util.tree_map(np.zeros_like, params[name])
        rebuilt, missed = torch_import.apply_translated(zeros, translated)
        assert not missed, missed
        flat_new, flat_ref = flatten_params(rebuilt), flatten_params(
            params[name])
        assert flat_new.keys() == flat_ref.keys(), name
        for path, ref in flat_ref.items():
            np.testing.assert_array_equal(flat_new[path], ref,
                                          err_msg=f"{name}/{path}")


def test_flat_kernel_keys_convert_like_nested(world):
    """use_pallas="always" stores the kernel paths' params under flat
    "a/b" keys; the converter reads both layouts the same."""
    jagent, _agent, _raw = make_pair(world, "never")
    params = jax.tree_util.tree_map(np.asarray, jagent.params)["params"]
    flat = dict(params)
    flat["adain"] = {f"a_fc/{k}": v for k, v in params["adain"]["a_fc"].items()}
    att = dict(params["decoder"]["feat_att_layer"])
    flat["decoder"] = dict(params["decoder"])
    flat["decoder"]["feat_att_layer"] = {
        f"{mod}/{k}": v for mod, leaves in att.items()
        for k, v in leaves.items()}
    nested, flat_sd = (policy_state_dict_from_jax(p) for p in (params, flat))
    assert nested.keys() == flat_sd.keys()
    for key in nested:
        np.testing.assert_array_equal(flat_sd[key], nested[key])
