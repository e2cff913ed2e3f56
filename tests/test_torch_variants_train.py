"""The port's training passes with the variants' auxiliary loss terms
against the JAX package.

Four of the variant configurations, at test widths on a synthetic 2-scan
world: (1) the BAttn decoder with the back head, the progress monitor
(``att_hid``) and the DyReLU candidates, channel AdaIN through the kernel
routes (``use_pallas="always"``); (3) the double agent with the COCO
AdaIN; (4) the advanced agent with the mean AdaIN; (8) the MT agent with
the rgb channel AdaIN.  The JAX agent and the port carry the same weights
(``policy_state_dict_from_jax``), every dropout rate is 0 and both take
the same env-drop noise.  The teacher pass (its replay body) must give
the same loss, the same logs (``pm_loss``, ``kl_loss`` among them) and the
same gradients; tests/test_torch_variants_fused.py holds the fused pass
and tests/test_torch_variants_stream.py the stream windows (one file a
pass: xdist hands out files whole).

Tolerances: tests/test_torch_train.py's loss rtol 1e-4 (the 768-wide
BERT's f32 sums round differently in XLA and PyTorch) and gradient rtol
2e-4; the gradient atol is 5e-6 where that file's is 1e-6, because the
heads add more terms to each encoder gradient (a sum over every step's
percept): one near-zero element of the top LSTM's input weights came out
1.2e-6 apart under the back, progress and DyReLU heads.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dasa_tpu.agents import Seq2SeqAgent as JaxAgent
from dasa_tpu.config import Config as JaxConfig
from dasa_tpu.data.features import FeatureDB as JaxFeatureDB
from dasa_tpu.env import R2REnv as JaxEnv
from dasa_tpu_torch.agents import Seq2SeqAgent
from dasa_tpu_torch.config import Config
from dasa_tpu_torch.data.datasets import (
    expand_instructions,
    load_datasets,
    make_synthetic_task,
)
from dasa_tpu_torch.data.features import FeatureDB
from dasa_tpu_torch.env import R2REnv
from dasa_tpu_torch.testing import torch_threads, write_synthetic_connectivity
from dasa_tpu_torch.utils import Tokenizer, build_vocab
from dasa_tpu_torch.utils.jax_params import policy_state_dict_from_jax

SCANS = ("synthA", "synthB")
DIM = 24
L = 24
CFG = dict(
    rnn_dim=32, wemb=16, aemb=8, critic_dim=32, angle_feat_size=8,
    feature_size=DIM, max_input=L, max_candidates=16, max_action=5,
    batch_size=2, d_enc_hidden_size=16, d_hidden_size=32, d_vl_layers=1,
    d_la_layers=1, encoder_type="Dic", include_vision=True,
    consistent_drop=True, depth_drop=True, featdropout=0.3, ml_weight=0.2,
    dropout=0.0, d_dropout_ratio=0.0, d_hidden_dropout_prob=0.0,
    d_attn_dropout_prob=0.0)
VARIANTS = {
    "battn_heads": dict(adain_type="channel", ab_type="a", a_type="sigmoid",
                        use_shift=True, shift_kernel_size=5, pred_back=True,
                        pred_pm=True, pm_type="att_hid",
                        decoder_type="dyrelu", use_pallas="always"),
    "double": dict(agent_type="double", adain_type="coco_channel",
                   ab_type="ab", a_type="sigmoid"),
    "advanced": dict(agent_type="advanced", adain_type="meanchannel"),
    "mt": dict(agent_type="mt", adain_type="rgb_channel", ab_type="a",
               a_type="sigmoid", use_pallas="always"),
}
# the logs the auxiliary terms must show, nonzero
AUX_LOGS = {"battn_heads": ("pm_loss",), "double": (),
            "advanced": ("pm_loss",), "mt": ("kl_loss",)}
LOSS_RTOL = 1e-4
GRAD_TOL = dict(rtol=2e-4, atol=5e-6)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_variants_world")
    conn, data = str(root / "connectivity"), str(root / "task")
    write_synthetic_connectivity(conn, SCANS, n_nodes=24, seed=0)
    make_synthetic_task(data, SCANS[:1], SCANS[1:], n_train=6, n_val=2,
                        connectivity_dir=conn)
    vocab = build_vocab(load_datasets(["train"], data), min_count=1)
    return conn, data, Tokenizer(vocab, encoding_length=L)


def make_pair(world, **kw):
    """JAX and port agents over the train split, the same weights."""
    conn, data, tok = world
    items = expand_instructions(load_datasets(["train"], data), tok,
                                max_input=L)
    kw = {**CFG, **kw}
    jfeat = JaxFeatureDB.synthetic(SCANS, conn, dim=DIM)
    jdepth = JaxFeatureDB.synthetic(SCANS, conn, dim=DIM, salt=7)
    jenv = JaxEnv(jfeat, items, batch_size=2, connectivity_dir=conn,
                  max_candidates=16, max_input=L, depth_db=jdepth)
    jagent = JaxAgent(JaxConfig(**kw, connectivity_dir=conn), jenv, jfeat,
                      depth_db=jdepth, vocab_size=len(tok), rng_seed=11)
    feat = FeatureDB.synthetic(SCANS, conn, dim=DIM)
    depth = FeatureDB.synthetic(SCANS, conn, dim=DIM, salt=7)
    env = R2REnv(feat, items, batch_size=2, connectivity_dir=conn,
                 max_candidates=16, max_input=L, depth_db=depth)
    agent = Seq2SeqAgent(Config(**kw, connectivity_dir=conn, data_dir=data),
                         env, feat, depth_db=depth, device="cpu")
    agent.load_jax_params(jax.tree_util.tree_map(np.asarray, jagent.params))
    return jagent, agent


def noise_vector(seed=3):
    keep = np.random.default_rng(seed).random(DIM) > 0.3
    return (keep / 0.7).astype(np.float32)


def assert_grads_match(agent, jax_grads):
    ref = policy_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jax_grads))
    got = {name: (torch.zeros_like(p) if p.grad is None else p.grad)
           .numpy() for name, p in agent.policy.named_parameters()}
    assert got.keys() == ref.keys()
    for name, grad in got.items():
        np.testing.assert_allclose(grad, ref[name], err_msg=name,
                                   **GRAD_TOL)


def assert_logs_match(name, agent, logs, keys):
    for key in ("loss", "ml_loss", "forth_loss", *keys):
        np.testing.assert_allclose(float(agent.logs[key][-1]),
                                   float(logs[key]), rtol=LOSS_RTOL,
                                   atol=1e-6, err_msg=key)
    for key in AUX_LOGS[name]:
        assert float(agent.logs[key][-1]) != 0.0, key


@pytest.mark.parametrize("name", list(VARIANTS))
def test_teacher_pass_matches_jax(world, name):
    """The teacher pass (train_ml 1: the gather-only walk and its
    batched-percept replay) with the auxiliary terms."""
    feedback = "teacher"
    jagent, agent = make_pair(world, **VARIANTS[name])
    noise = noise_vector()
    train_ml = 1.0 if feedback == "teacher" else 0.2
    args = list(jagent._device_rollout_args(feedback, train_ml, False))
    args[8] = jnp.asarray(noise)
    grads, logs = jagent._device_grad_fn(feedback, True)(
        jagent.params, jagent.tables, jagent._dev_env.arrays(), *args)
    agent.zero_grad()
    agent.device_rollout(train_ml=train_ml, train_rl=feedback == "argmax",
                         feedback=feedback, env_noise=torch.from_numpy(noise))
    assert_logs_match(name, agent, logs, AUX_LOGS[name])
    assert int(agent._env_steps_log[-1]) == int(logs["env_steps"])
    if VARIANTS[name].get("pred_back"):
        # the back head's weighted sum rides the ML loss
        back = float(agent.logs["back_loss"][-1])
        ml = float(agent.logs["ml_loss"][-1])
        pm = float(agent.logs["pm_loss"][-1])
        assert back > 0.0
        np.testing.assert_allclose(
            float(agent.logs["forth_loss"][-1]) + back + pm, ml, rtol=1e-6)
    assert_grads_match(agent, grads)
