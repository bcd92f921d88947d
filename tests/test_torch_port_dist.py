"""Port parity, data-parallel: ``parallel/dist.py`` and the W-rank paths of
pointnav_vo_tpu_torch against the JAX package's mesh (8 virtual CPU
devices, ``tests/conftest.py``) and against the port's one-rank run.

The port's ranks are W gloo processes on the CPU started by
``parallel.dist.spawn`` (one torch thread each; the rank functions live in
``tests/_torch_dist_ranks.py``, which imports no JAX).  Each spawn runs
several checks, because every rank pays for importing torch.  Inputs come
from numpy seeds; weights cross through ``io/weights.py``; JAX's per-shard
minibatch orders (its ``fold_in`` of the axis index) are injected.

Tolerances (float32; a W-rank sum runs in another order than one rank's):
the advantage statistic rtol 1e-6; the whitening buffers rtol 1e-5, atol
1e-7, the count exactly; PPO parameters atol 1e-5 (the JAX package's own
mesh test), loss terms rtol 1e-4, atol 1e-6; the VO step's loss and
metrics rtol 1e-5, atol 1e-7, its parameters within 2 lr everywhere and
within 1e-6 where the gradient exceeds 1e-2 of its tensor's max (Adam's
first step moves a weight by about lr sign(g), and the mean of four ranks'
gradients cancels: an element near 1e-3 of its tensor's max can take
either sign with the order of the sum); parameters across ranks
``torch.equal``; the eval's per-episode records equal in their counts,
successes and episode keys, rtol 1e-5 on their floats against the one-rank
run and rtol 1e-4 against JAX.
"""

import concurrent.futures
import dataclasses
import glob
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from pointnav_vo_tpu.models.policy import PointNavActorCritic as JPolicy
from pointnav_vo_tpu.models.running_mean_var import RunningMeanAndVar as JRMV
from pointnav_vo_tpu.parallel import mesh as jmesh
from pointnav_vo_tpu.rl import envs as jenvs
from pointnav_vo_tpu.rl import ppo as jppo
from pointnav_vo_tpu.rl import rollout as jrollout
from pointnav_vo_tpu.rl.eval import Evaluator as JEvaluator
from pointnav_vo_tpu.vo import dataset as jdataset
from pointnav_vo_tpu.vo import engine as jengine
from pointnav_vo_tpu.vo.ensemble import VOEnsemble as JEnsemble
from pointnav_vo_tpu.vo.ensemble import VOInferenceConfig as JCfg
from pointnav_vo_tpu.vo.ensemble import stack_expert_variables

from pointnav_vo_tpu_torch import run as trun
from pointnav_vo_tpu_torch.io.checkpoint import load_checkpoint
from pointnav_vo_tpu_torch.io.weights import (
    policy_state_dict_from_jax,
    policy_variables_from_state_dict,
    split_expert_variables,
    stacked_vo_variables,
    vo_state_dict_from_jax,
    vo_state_dicts_from_stacked,
    vo_variables_from_state_dict,
)
from pointnav_vo_tpu_torch.models.running_mean_var import RunningMeanAndVar as TRMV
from pointnav_vo_tpu_torch.parallel import dist as tdist

import _torch_dist_ranks as ranks
from _utils import fast_init
from test_eval import GreedyGoalPolicy as JGreedy

try:  # jax >= 0.4.35 exposes shard_map at top level
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RL_YAML = os.path.join(REPO, "configs/rl/ddppo_pointnav.yaml")
VO_YAML = os.path.join(REPO, "configs/vo/vo_pointnav.yaml")
W_RANKS = 4  # the collectives' ranks
S = 32  # frames and sensors
HIDDEN = 32
VO_HIDDEN = 64
VO_BATCH = 16  # 4 twins a rank
VO_LR = 2.5e-4
GOAL = "pointgoal_with_gps_compass"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs six test processes on the box's cores; the spawned ranks
    split this process's one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


# ---------------------------------------------------------------- rendezvous


@pytest.mark.parametrize("nodelist", ["nid001", "nid[001-004]", "nid[001,005-008]",
                                      "gpu[1,3-5]-rack,cpu7", "a1,b[2-3]", "c[10]d[2-4]"])
def test_slurm_first_host_matches_jax(nodelist):
    assert tdist.slurm_first_host(nodelist) == jmesh.slurm_first_host(nodelist)


_RANK_VARS = ("SLURM_NTASKS", "SLURM_PROCID", "SLURM_LOCALID", "SLURM_STEP_NODELIST",
              "SLURM_STEP_TASKS_PER_NODE", "JAX_COORDINATOR_ADDRESS", "MASTER_ADDR",
              "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE")


@pytest.fixture
def captured_init(monkeypatch):
    """Both packages' rendezvous calls, recorded instead of made."""
    for var in _RANK_VARS:
        monkeypatch.delenv(var, raising=False)
    calls = {"torch": [], "jax": []}
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: calls["torch"].append(dict(kw, backend=backend)))
    monkeypatch.setattr(jax.distributed, "initialize", lambda **kw: calls["jax"].append(kw))
    return calls


def test_init_distributed_single_host_is_noop(captured_init):
    assert tdist.init_distributed("cpu") is None
    jmesh.init_distributed()
    assert captured_init == {"torch": [], "jax": []}


def test_init_distributed_slurm_rendezvous(monkeypatch, captured_init):
    for k, v in {"SLURM_NTASKS": "4", "SLURM_PROCID": "2", "SLURM_LOCALID": "0",
                 "SLURM_STEP_NODELIST": "node[0-3],nodeX",
                 "SLURM_STEP_TASKS_PER_NODE": "1(x4)"}.items():
        monkeypatch.setenv(k, v)
    group = tdist.init_distributed("cpu")
    jmesh.init_distributed()
    (kw,), (jkw,) = captured_init["torch"], captured_init["jax"]
    assert kw["init_method"] == "tcp://" + jkw["coordinator_address"] == "tcp://node0:8476"
    assert (kw["rank"], kw["world_size"]) == (jkw["process_id"], jkw["num_processes"]) == (2, 4)
    assert kw["backend"] == group.backend == "gloo"
    assert (group.rank, group.world, group.local_rank, group.local_world) == (2, 4, 0, 1)
    assert (group.node, group.nodes) == (2, 4)


def test_init_distributed_explicit_coordinator(monkeypatch, captured_init):
    """torchrun's variables: the coordinator from MASTER_ADDR/MASTER_PORT."""
    for k, v in {"WORLD_SIZE": "2", "RANK": "1", "MASTER_ADDR": "10.0.0.1",
                 "MASTER_PORT": "1234"}.items():
        monkeypatch.setenv(k, v)
    group = tdist.init_distributed("cpu")
    (kw,) = captured_init["torch"]
    assert kw["init_method"] == "tcp://10.0.0.1:1234"
    assert (kw["rank"], kw["world_size"], group.local_rank, group.local_world) == (1, 2, 1, 2)


# ---------------------------------------------------------------- collectives


def _mesh_fn(fn, in_specs):
    return jax.jit(shard_map(fn, mesh=jmesh.make_mesh(W_RANKS), in_specs=in_specs,
                             out_specs=P(), check_vma=False))


def _rollout(t, n, h, w, seed):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    d = dict(
        observations={"depth": rng.uniform(0, 1, (t + 1, n, h, w, 1)).astype(f32),
                      GOAL: rng.uniform(0, 1, (t + 1, n, 2)).astype(f32)},
        hidden_states=rng.normal(0, 0.5, (t + 1, 4, n, HIDDEN)).astype(f32),
        rewards=rng.normal(size=(t, n, 1)).astype(f32),
        value_preds=rng.normal(size=(t + 1, n, 1)).astype(f32),
        returns=np.zeros((t + 1, n, 1), f32),
        action_log_probs=np.log(rng.uniform(0.1, 0.9, (t, n, 1))).astype(f32),
        actions=rng.integers(0, 4, (t, n, 1)).astype(np.int32),
        prev_actions=rng.integers(0, 4, (t + 1, n, 1)).astype(np.int32),
        masks=(rng.uniform(size=(t + 1, n, 1)) > 0.2).astype(f32),
    )
    js = jrollout.RolloutStorage(**{
        k: ({o: jnp.asarray(a) for o, a in v.items()} if k == "observations"
            else jnp.asarray(v)) for k, v in d.items()})
    js = jrollout.compute_returns(js, jnp.asarray(d["value_preds"][t]), True, 0.99, 0.95)
    d["returns"] = np.asarray(js.returns)
    d["actions"], d["prev_actions"] = (d[k].astype(np.int64) for k in ("actions",
                                                                       "prev_actions"))
    return js, d


def _jax_order(rng, cfg, n_envs):
    """The minibatch order JAX's ppo_update draws from ``rng``."""
    n_per_mb = n_envs // cfg.num_mini_batch
    out = []
    for _ in range(cfg.ppo_epoch):
        rng, sub = jax.random.split(rng)
        perm = np.asarray(jax.random.permutation(sub, n_envs))
        out.append(perm[: n_per_mb * cfg.num_mini_batch].reshape(cfg.num_mini_batch, n_per_mb))
    return np.stack(out)


def _jax_vo_experts(n, seed=0):
    """Random experts in the JAX layout with whitening statistics already
    accumulated (fast_init would draw a random count)."""
    model = JCfg(vis_size_w=S, vis_size_h=S, hidden_size=VO_HIDDEN, dropout_p=0.0).make_model()
    dummy = {"rgb": jnp.zeros((1, S, S, 6)), "depth": jnp.zeros((1, S, S, 2)),
             "discretized_depth": jnp.zeros((1, S, S, 20)),
             "top_down_view": jnp.zeros((1, S, S, 2))}
    rng = np.random.default_rng(100 + seed)
    per = []
    for i in range(n):
        v = fast_init(model, dummy, train=False, seed=seed + i)
        c = v["batch_stats"]["visual_encoder"]["rmv"]["mean"].shape[0]
        v["batch_stats"] = {"visual_encoder": {"rmv": {
            "mean": jnp.asarray(rng.uniform(0, 0.5, c), jnp.float32),
            "var": jnp.asarray(rng.uniform(0.05, 0.3, c), jnp.float32),
            "count": jnp.asarray(40.0)}}}
        per.append(v)
    return per


@pytest.fixture(scope="module")
def vo_data(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("dist_vo") / "train.h5")
    env_cfg = jenvs.EnvConfig(image_h=S, image_w=S, max_episode_steps=60)
    assert jdataset.generate_scripted_dataset(path, 64, env_cfg=env_cfg, seed=0) == 64
    return path


@pytest.fixture(scope="module")
def collective_runs(vo_data):
    """The JAX mesh results, the port's one-rank results and every rank's
    results of one 4-rank spawn, on the same inputs.  The ranks run while
    this process compiles JAX's programs."""
    rng = np.random.default_rng(0)
    data, want = {}, {}
    # the advantage statistic (an env block a rank)
    data["adv"] = rng.normal(2.0, 3.0, (6, 8, 1)).astype(np.float32)
    # the whitening update, with a partial stats mask
    c = 5
    x = rng.normal(1.0, 2.0, (8, 4, 3, c)).astype(np.float32)
    mask = (rng.uniform(size=8) > 0.3).astype(np.float32)
    init = {"mean": rng.uniform(0, 0.5, c).astype(np.float32),
            "var": rng.uniform(0.05, 0.3, c).astype(np.float32),
            "count": np.asarray(12.0, np.float32)}
    data["rmv_x"] = np.ascontiguousarray(x.transpose(0, 3, 1, 2))
    data["rmv_mask"] = mask
    data["rmv_init"] = {"_mean": init["mean"].reshape(1, c, 1, 1),
                        "_var": init["var"].reshape(1, c, 1, 1), "_count": init["count"]}
    # PPO: test_rl.py::test_sharded_update_matches_single_device's setting
    t, n, h = 4, 8, 16
    kw = dict(num_mini_batch=1, ppo_epoch=1, use_normalized_advantage=True, num_steps=t,
              hidden_size=HIDDEN)
    jcfg = jppo.PPOConfig(**kw)
    policy_kw = dict(image_size=(h, h), hidden_size=HIDDEN, baseplanes=8)
    jpol = JPolicy(**policy_kw)
    pvars = jax.tree.map(np.asarray, fast_init(
        jpol, {"depth": jnp.zeros((n, h, h, 1)), GOAL: jnp.zeros((n, 2))},
        jpol.initial_hidden(n), jnp.zeros((n, 1), jnp.int32), jnp.zeros((n, 1)), seed=4))
    js, d = _rollout(t, n, h, h, seed=12)
    rng_key = jax.random.PRNGKey(1)
    n_loc = n // W_RANKS
    orders = [_jax_order(jax.random.fold_in(rng_key, s), jcfg, n_loc) for s in range(W_RANKS)]
    data.update(policy_kw=policy_kw, ppo_cfg=kw, rollout=d, orders=orders,
                policy={k: v.numpy() for k, v in policy_state_dict_from_jax(pvars).items()})
    # the VO joint step: VORegressionEngine(mesh=make_mesh(4)), dropout off
    stage = dict(action_type=(2, 3), geo_invariance_types=("inverse_joint_train",))
    jeng = jengine.VORegressionEngine(
        JCfg(vis_size_w=S, vis_size_h=S, hidden_size=VO_HIDDEN, dropout_p=0.0),
        jengine.VOTrainConfig(batch_size=VO_BATCH, lr=VO_LR, **stage),
        init_variables_per_expert=_jax_vo_experts(2), mesh=jmesh.make_mesh(W_RANKS))
    reader = jdataset.FramePairReader(vo_data, S, S, act_type=(2, 3),
                                      geo_invariance_types=stage["geo_invariance_types"])
    batch = next(reader.iter_batches(VO_BATCH, rng=np.random.default_rng(11), drop_last=True))
    assert batch.twins_packed
    data.update(vo_icfg=dict(vis_size_w=S, vis_size_h=S, hidden_size=VO_HIDDEN, dropout_p=0.0),
                vo_tcfg=dict(batch_size=VO_BATCH, lr=VO_LR, **stage),
                vo_batch=dataclasses.asdict(batch),
                vo_experts=[{k: v.numpy() for k, v in sd.items()} for sd in
                            vo_state_dicts_from_stacked(jax.tree.map(np.asarray,
                                                                     jeng.variables))])

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        spawned = pool.submit(tdist.spawn, ranks.collectives, W_RANKS, "cpu", data)

        want["mean_var"] = [float(v) for v in _mesh_fn(
            lambda a: jppo.distributed_mean_and_var(a, jmesh.DATA_AXIS),
            P(None, jmesh.DATA_AXIS))(jnp.asarray(data["adv"]))]
        jm = JRMV(c, axis_name=jmesh.DATA_AXIS)

        def rmv_update(xs, ms):
            _, mut = jm.apply({"batch_stats": {k: jnp.asarray(v) for k, v in init.items()}},
                              xs, update_stats=True, stats_mask=ms, mutable=["batch_stats"])
            return mut["batch_stats"]

        want["rmv"] = jax.tree.map(np.asarray, _mesh_fn(
            rmv_update, (P(jmesh.DATA_AXIS), P(jmesh.DATA_AXIS)))(jnp.asarray(x),
                                                                  jnp.asarray(mask)))
        one = TRMV(c)
        for k, v in data["rmv_init"].items():
            getattr(one, k).copy_(torch.from_numpy(v))
        one(torch.from_numpy(data["rmv_x"]), update_stats=True,
            stats_mask=torch.from_numpy(mask))
        want["rmv_one"] = {k: v.numpy() for k, v in one.named_buffers()}

        tx = jppo.make_optimizer(jcfg)
        sharded = jax.jit(shard_map(
            lambda p, o, r, k: jppo.ppo_update(
                jpol, jcfg, tx, p, o, r,
                jax.random.fold_in(k, jax.lax.axis_index(jmesh.DATA_AXIS)),
                axis_name=jmesh.DATA_AXIS),
            mesh=jmesh.make_mesh(W_RANKS), in_specs=(P(), P(), jmesh.rollout_pspec(js), P()),
            out_specs=(P(), P(), P()), check_vma=False))
        jparams, _, jstats = sharded(pvars["params"], tx.init(pvars["params"]), js, rng_key)
        want["ppo_params"] = jax.tree.map(np.asarray, jparams)
        want["ppo_stats"] = {k: float(v) for k, v in jstats.items()}
        # the one-rank update on the union of the ranks' orders, in global env indices
        union = np.concatenate([o + s * n_loc for s, o in enumerate(orders)], axis=-1)
        want["ppo_one"] = ranks.ppo_run(None, policy_kw, data["policy"], kw, d, union)

        arrs = jeng._attach_train_buckets(jengine._batch_to_device(batch), batch)
        assert "bucket_idx_0" in arrs
        jvars, _, jmetrics = jeng._train_step(jeng.variables, jeng.opt_state, arrs,
                                              jax.random.PRNGKey(0))
        want["vo_vars"] = jax.tree.map(np.asarray, jvars)
        want["vo_metrics"] = {k: np.asarray(v) for k, v in jmetrics.items()}
        got = spawned.result()
    assert len(got) == W_RANKS
    return want, got


def test_distributed_mean_and_var_matches_jax_psum(collective_runs):
    want, got = collective_runs
    for rank in got:
        np.testing.assert_allclose(rank["mean_var"], want["mean_var"], rtol=1e-6)


def test_whitening_update_matches_jax_psum(collective_runs):
    want, got = collective_runs
    rmv = got[0]["rmv"]
    assert float(rmv["_count"]) == float(want["rmv"]["count"])
    for k in ("mean", "var"):
        np.testing.assert_allclose(rmv[f"_{k}"].reshape(-1), want["rmv"][k], rtol=1e-5,
                                   atol=1e-7, err_msg=k)


def test_whitening_update_matches_one_rank(collective_runs):
    want, got = collective_runs
    for rank in got:
        assert float(rank["rmv"]["_count"]) == float(want["rmv_one"]["_count"])
        for k in ("_mean", "_var"):
            np.testing.assert_allclose(rank["rmv"][k], want["rmv_one"][k], rtol=1e-5,
                                       atol=1e-7, err_msg=k)


def test_ppo_update_matches_jax_sharded_update(collective_runs):
    want, got = collective_runs
    params, stats = got[0]["ppo"]
    got_p = dict(_leaves({"params": want["ppo_params"]}))
    mine = dict(_leaves(policy_variables_from_state_dict(
        {k: torch.from_numpy(v) for k, v in params.items()})))
    assert set(mine) == set(got_p)
    for k, w in got_p.items():
        np.testing.assert_allclose(mine[k], w, atol=1e-5, err_msg=k)
    for k, v in want["ppo_stats"].items():
        np.testing.assert_allclose(stats[k], v, rtol=1e-4, atol=1e-6, err_msg=k)


def test_ppo_update_matches_one_rank(collective_runs):
    want, got = collective_runs
    params, stats = got[0]["ppo"]
    one_params, one_stats = want["ppo_one"]
    assert set(params) == set(one_params)
    for k, w in one_params.items():
        np.testing.assert_allclose(params[k], w, atol=1e-5, err_msg=k)
    for k, v in one_stats.items():
        np.testing.assert_allclose(stats[k], v, rtol=1e-4, atol=1e-6, err_msg=k)


def test_parameters_equal_across_ranks(collective_runs):
    _, got = collective_runs
    for rank in got[1:]:
        for k, v in got[0]["ppo"][0].items():
            assert torch.equal(torch.from_numpy(rank["ppo"][0][k]), torch.from_numpy(v)), k
        assert rank["ppo"][1] == got[0]["ppo"][1]
        for mine, first in zip(rank["vo"][1], got[0]["vo"][1]):
            for k, v in first.items():  # parameters, whitening buffers and all
                assert torch.equal(torch.from_numpy(mine[k]), torch.from_numpy(v)), k
        for k, v in got[0]["vo"][0].items():
            assert np.array_equal(rank["vo"][0][k], v), k


def test_vo_joint_step_matches_jax_mesh(collective_runs):
    want, got = collective_runs
    metrics, experts, grads = got[0]["vo"]
    assert set(metrics) == set(want["vo_metrics"])
    for k, w in want["vo_metrics"].items():
        np.testing.assert_allclose(metrics[k], w, rtol=1e-5, atol=1e-7, err_msg=k)
    mine = stacked_vo_variables([vo_variables_from_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()}) for sd in experts])
    g = dict(_leaves(stacked_vo_variables([vo_variables_from_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()}) for sd in grads])["params"]))
    stats = dict(_leaves(mine["batch_stats"]))
    for k, w in _leaves(want["vo_vars"]["batch_stats"]):
        np.testing.assert_allclose(stats[k], w, rtol=1e-5, err_msg=k)
    params = dict(_leaves(mine["params"]))
    for k, w in _leaves(want["vo_vars"]["params"]):
        err = np.abs(params[k] - w)
        assert float(err.max()) <= 2 * VO_LR, k
        strong = np.abs(g[k]) > 1e-2 * np.abs(g[k]).max()
        assert float(err[strong].max(initial=0.0)) <= 1e-6, k


# ---------------------------------------------------------------- eval


EVAL_CASES = {"even budgets": dict(seed=9, episodes=8, one_episode_envs=0),
              "skewed budgets": dict(seed=13, episodes=14, one_episode_envs=3)}
EVAL_ENVS = 8
EVAL_RANKS = 2


def _eval_case(seed, episodes, one_episode_envs):
    icfg = dict(vis_size_w=S, vis_size_h=S)
    model = JCfg(**icfg).make_model()
    dummy = {"rgb": jnp.zeros((1, S, S, 6)), "depth": jnp.zeros((1, S, S, 2)),
             "discretized_depth": jnp.zeros((1, S, S, 20)),
             "top_down_view": jnp.zeros((1, S, S, 2))}
    per = [fast_init(model, dummy, train=False, seed=i) for i in range(3)]
    stacked = stack_expert_variables(per)
    experts = [{k: v.numpy() for k, v in vo_state_dict_from_jax(e).items()}
               for e in split_expert_variables(jax.tree.map(np.asarray, stacked))]
    env_kw = dict(image_h=S, image_w=S, max_episode_steps=12, actuation_noise_multiplier=0.0,
                  rgb_noise_intensity=0.0, depth_noise_multiplier=0.0)
    return dict(seed=seed, episodes=episodes, one_episode_envs=one_episode_envs,
                n_envs=EVAL_ENVS, env_kw=env_kw, icfg=icfg, experts=experts,
                stacked=stacked)


@pytest.fixture(scope="module")
def eval_runs():
    """Per case: JAX's mesh eval over 2 devices, the port's one-rank run
    and its 2-rank run (one spawn for both cases, running meanwhile)."""
    cases = {name: _eval_case(**kw) for name, kw in EVAL_CASES.items()}
    stacked = {name: case.pop("stacked") for name, case in cases.items()}
    out = {}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        spawned = pool.submit(tdist.spawn, ranks.evaluate_cases, EVAL_RANKS, "cpu",
                              list(cases.values()))
        for name, case in cases.items():
            cfg = jenvs.EnvConfig(**case["env_kw"])
            envs = jenvs.make_scripted_vector_env(cfg, EVAL_ENVS, seed=case["seed"])
            for e in envs.envs[:case["one_episode_envs"]]:
                e.number_of_episodes = 1
            jev = JEvaluator(model=JGreedy(turn_angle_deg=cfg.turn_angle_deg,
                                           success_distance=cfg.success_distance),
                             variables={"params": {}}, envs=envs,
                             vo_ensemble=JEnsemble(JCfg(**case["icfg"]), stacked[name]),
                             rng=jax.random.PRNGKey(0), mesh=jmesh.make_mesh(EVAL_RANKS))
            agg = jev.run(num_episodes=case["episodes"])
            out[name] = {"jax": (agg, [dataclasses.asdict(r) for r in jev.results]),
                         "one": ranks.evaluate(None, case)}
        for name, result in zip(cases, spawned.result()):
            out[name]["ranks"] = result
    return out


_EXACT = ("success", "steps", "episode_id", "collisions", "dx_stuck", "dz_stuck",
          "both_stuck")
_FLOATS = ("spl", "softspl", "distance_to_goal", "reward", "vo_l2_mean", "drift_mean")


def _assert_episodes_match(got, want, rtol):
    assert len(got) == len(want)
    for g, w in zip(got, want, strict=True):
        for k in _EXACT:
            assert g[k] == w[k], k
        for k in _FLOATS:
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("case", list(EVAL_CASES))
def test_evaluator_matches_one_rank(eval_runs, case):
    agg, episodes, keys = eval_runs[case]["ranks"]
    one_agg, one_episodes, one_keys = eval_runs[case]["one"]
    assert keys == one_keys  # the same episode set, in the same order
    _assert_episodes_match(episodes, one_episodes, rtol=1e-5)
    assert set(agg) == set(one_agg)
    for k in ("episodes", "success", "total_env_steps", "stuck_dx", "stuck_dz", "stuck_both",
              "vo_near_zero_dx", "vo_near_zero_dz", "vo_near_zero_both"):
        assert agg[k] == one_agg[k], k
    for k in ("spl", "softspl", "distance_to_goal", "reward", "vo_l2_mean", "vo_l2_max",
              "global_drift_mean"):
        np.testing.assert_allclose(agg[k], one_agg[k], rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("case", list(EVAL_CASES))
def test_evaluator_matches_jax_mesh(eval_runs, case):
    agg, episodes, _ = eval_runs[case]["ranks"]
    jagg, jepisodes = eval_runs[case]["jax"]
    assert agg["episodes"] == jagg["episodes"] == EVAL_CASES[case]["episodes"]
    _assert_episodes_match(episodes, jepisodes, rtol=1e-4)
    for k in ("success", "spl", "distance_to_goal", "total_env_steps", "vo_l2_mean"):
        np.testing.assert_allclose(agg[k], jagg[k], rtol=1e-4, err_msg=k)


# ---------------------------------------------------------------- the CLI


def _rl_opts(extra=()):
    return ["NUM_PROCESSES", "4", "SEED", "3", "RL.PPO.hidden_size", str(HIDDEN),
            "RL.PPO.num_steps", "4", "VO.USE_VO_MODEL", "True", "VO.VIS_SIZE_W", str(S),
            "VO.VIS_SIZE_H", str(S), "VO.REGRESS_MODEL.hidden_size", str(HIDDEN),
            "VO.REGRESS_MODEL.pretrained", "False",
            "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.HEIGHT", str(S),
            "TASK_CONFIG.SIMULATOR.DEPTH_SENSOR.WIDTH", str(S),
            "TASK_CONFIG.SIMULATOR.RGB_SENSOR.HEIGHT", str(S),
            "TASK_CONFIG.SIMULATOR.RGB_SENSOR.WIDTH", str(S),
            "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", "12", "EVAL.TEST_EPISODE_COUNT", "4",
            "CHECKPOINT_INTERVAL", "1", "LOG_INTERVAL", "1", *extra]


def _cli(root, task, run_type, opts, ranks_=2):
    return trun.main(["--task-type", task, "--run-type", run_type, "--exp-config",
                      RL_YAML if task == "rl" else VO_YAML, "--log-root", str(root),
                      "--device", "cpu", "--noise", "0" if task == "rl" else "1",
                      "--n-devices", str(ranks_), *opts])


def _checkpoints(root, prefix):
    (run_dir,) = glob.glob(os.path.join(str(root), prefix + "*"))
    return run_dir, sorted(os.listdir(os.path.join(run_dir, "checkpoints")))


@pytest.fixture(scope="module")
def rl_cli(tmp_path_factory):
    """RL train of 2 updates over 2 ranks, a resume to update 3, and the
    eval of the last checkpoint over 2 ranks and over one."""
    root = tmp_path_factory.mktemp("dist_cli")
    assert _cli(root / "train", "rl", "train", _rl_opts(["NUM_UPDATES", "2"])) is None
    run_dir, ckpts = _checkpoints(root / "train", "rl-train-")
    last = os.path.join(run_dir, "checkpoints", ckpts[-1])
    _cli(root / "resume", "rl", "train", _rl_opts(
        ["NUM_UPDATES", "3", "RESUME_TRAIN", "True", "RESUME_STATE_FILE", last]))
    evals = {w: _cli(root / f"eval{w}", "rl", "eval", _rl_opts(["EVAL.EVAL_CKPT_PATH", last]),
                     ranks_=w) for w in (1, 2)}
    return dict(root=root, ckpts=ckpts, last=last, evals=evals)


def test_cli_rl_train_writes_each_checkpoint_once_from_rank_0(rl_cli):
    # 4 envs x 4 steps an update, counted over both ranks
    assert rl_cli["ckpts"] == ["ckpt_0.update_0.frames_16.pth", "ckpt_1.update_1.frames_32.pth"]
    state = load_checkpoint(rl_cli["last"])
    assert state["update"] == 1 and state["count_steps"] == 32
    gens = state["rank_generators"]
    assert len(gens) == 2 and torch.equal(gens[0]["state"], state["generator"]["state"])
    assert not torch.equal(gens[0]["state"], gens[1]["state"])


def test_cli_rl_resume_continues_to_update_3(rl_cli):
    _, ckpts = _checkpoints(rl_cli["root"] / "resume", "rl-train-")
    assert ckpts == ["ckpt_1.update_1.frames_48.pth", "ckpt_2.update_2.frames_64.pth"]


def test_cli_rl_eval_over_two_ranks_matches_one(rl_cli):
    got, want = rl_cli["evals"][2], rl_cli["evals"][1]
    assert got["episodes"] == want["episodes"] == 4
    for k in want:
        if not k.startswith("time_") and k != "wall_clock_s":
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_cli_vo_train_over_two_ranks_matches_one(vo_data, tmp_path):
    """One epoch of the forward stage (one loss group: every rank's mean
    is over as many rows, so two ranks compute the one-rank loss)."""
    opts = ["VO.VIS_SIZE_W", str(S), "VO.VIS_SIZE_H", str(S), "VO.MODEL.hidden_size",
            str(HIDDEN), "VO.MODEL.dropout_p", "0.0", "VO.MODEL.pretrained", "False",
            "VO.TRAIN.batch_size", "8", "VO.TRAIN.epochs", "1", "VO.TRAIN.action_type", "1",
            "VO.DATASET.TRAIN_WITH_NOISE", vo_data, "VO.DATASET.EVAL_WITH_NOISE", vo_data,
            "LOG_INTERVAL", "1"]
    out = {}
    for w in (1, 2):
        _cli(tmp_path / str(w), "vo", "train", opts, ranks_=w)
        run_dir, ckpts = _checkpoints(tmp_path / str(w), "vo-train-")
        assert ckpts == ["ckpt_epoch_1.pth"]
        with open(os.path.join(run_dir, "infos", "train_regression_info.p"), "rb") as f:
            info = pickle.load(f)
        out[w] = (info, load_checkpoint(os.path.join(run_dir, "checkpoints", ckpts[0])))
    (info2, state2), (info1, state1) = out[2], out[1]
    np.testing.assert_allclose(info2["mean_total_loss"], info1["mean_total_loss"], rtol=1e-4)
    np.testing.assert_allclose(info2["eval_abs_diff_dz"], info1["eval_abs_diff_dz"], rtol=1e-3)
    for k, v in state1["experts"][0].items():
        if "running_mean_and_var" in k:
            np.testing.assert_allclose(state2["experts"][0][k].numpy(), v.numpy(), rtol=1e-5,
                                       err_msg=k)
    assert len(state2["rank_generators"]) == 2


def test_a_failing_rank_fails_the_run(tmp_path):
    """Rank 1 raises while rank 0 waits in a collective: the launcher
    stops rank 0 and raises; an env count the ranks cannot split fails
    ``run.main``."""
    with pytest.raises(Exception, match="rank 1 failed on purpose"):
        tdist.spawn(ranks.fail_on_rank_1, 2, "cpu")
    with pytest.raises(Exception, match="do not split evenly"):
        _cli(tmp_path, "rl", "train", _rl_opts(["NUM_PROCESSES", "3", "NUM_UPDATES", "1"]))
