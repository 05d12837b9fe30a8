"""The port's mesh layer (``ivosw_tpu_torch/parallel/mesh.py``) and its
users, one counterpart for each case of ``tests/test_parallel.py`` with the
same sizes and bounds. The JAX tests' eight virtual CPU devices are the
mesh ``[cpu]*8`` here (a device may repeat in the port's mesh). Where the
case has a one-device JAX function, the port is also held against it."""

import json
import threading

import numpy as np
import pytest
import torch

from ivosw_tpu_torch.core.config import Config
from ivosw_tpu_torch.data.registry import SequenceRegistry
from ivosw_tpu_torch.parallel.mesh import (
    apply_shardings,
    assess_param_shardings,
    frame_sharded_score_clip,
    make_mesh,
    replicate,
    shard_batch,
)

CPU8 = ["cpu"] * 8


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads leave the cores to the other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jax_assess_variables():
    import jax

    from ivosw_tpu.models.assess import init_assess_variables

    return jax.tree.map(lambda x: np.asarray(x, np.float32),
                        init_assess_variables(jax.random.PRNGKey(0)))


def _port_assess(variables, fold):
    from ivosw_tpu_torch.models.assess import AssessNet
    from ivosw_tpu_torch.models.fold import fold_assess_variables
    from ivosw_tpu_torch.utils.convert import assess_state_dict_from_numpy

    state = assess_state_dict_from_numpy(variables)
    net = AssessNet(fold=fold)
    net.load_state_dict(fold_assess_variables(state) if fold else state)
    return net.eval()


def test_make_mesh_shapes():
    mesh1 = make_mesh(("data",), devices=CPU8)
    assert mesh1.shape["data"] == 8
    mesh2 = make_mesh(("data", "model"), devices=CPU8)
    assert mesh2.shape["data"] * mesh2.shape["model"] == 8
    assert mesh2.shape["model"] == 4
    assert mesh1 == make_mesh(devices=CPU8) and hash(mesh1) == hash(make_mesh(devices=CPU8))
    if torch.cuda.device_count() == 0:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
    # contiguous blocks per device (JAX's P('data')); a ragged axis raises
    blocks = shard_batch(mesh1, {"x": np.arange(16).reshape(8, 2)})
    assert [b["x"].tolist() for b in blocks[:2]] == [[[0, 1]], [[2, 3]]]
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(mesh1, {"x": np.zeros(6)})
    net = torch.nn.Linear(2, 2)
    replicas = replicate(mesh1, net)
    assert replicas[0] is net and len({id(r) for r in replicas}) == 8


def test_sharded_dqn_update_matches_single_device():
    """The data-parallel Q-update over 8 shards gives the one-device
    update's loss and parameters (bounds of the JAX test)."""
    from ivosw_tpu_torch.models.agent import BATCH_KEYS, dqn_loss, dqn_update_step, make_optimizer
    from ivosw_tpu_torch.models.brain import init_brain

    rng = np.random.default_rng(0)
    b, t = 8, 8
    batch = {
        "action": rng.integers(0, t, b).astype(np.int32),
        "reward_step": rng.choice([-1.0, 1.0], b).astype(np.float32),
        "reward_done": rng.normal(size=b).astype(np.float32),
        "old_state_iou": rng.random((b, t)).astype(np.float32),
        "new_state_iou": rng.random((b, t)).astype(np.float32),
        "annotated_frames": np.zeros((b, t), np.float32),
        "next_annotated_frames": np.ones((b, t), np.float32),
    }
    assert set(batch) == set(BATCH_KEYS)

    brain, target = init_brain(0), init_brain(1)
    optimizer = make_optimizer(brain.parameters(), 5e-6, 5e-4)
    loss_single = dqn_update_step(brain, target, optimizer, {k: torch.from_numpy(v)
                                                             for k, v in batch.items()}, 0.95)

    # the sharded update: each replica of (brain, target) back-propagates its
    # block's summed losses / B, the gradients are summed onto the first,
    # clamped as dqn_update_step clamps them, and one step runs there
    mesh = make_mesh(devices=CPU8)
    pair = torch.nn.ModuleDict({"brain": init_brain(0), "target": init_brain(1)})
    optimizer = make_optimizer(pair["brain"].parameters(), 5e-6, 5e-4)
    replicas = replicate(mesh, pair)
    loss_sharded = torch.zeros(())
    for replica, block in zip(replicas, shard_batch(mesh, batch)):
        n = block["action"].shape[0]
        loss = dqn_loss(replica["brain"], replica["target"], block, 0.95) * n / b
        loss.backward()
        loss_sharded += loss.detach()
    with torch.no_grad():
        for replica in replicas[1:]:
            for p0, p in zip(pair.parameters(), replica.parameters()):
                if p.grad is not None:
                    p0.grad = p.grad if p0.grad is None else p0.grad.add_(p.grad)
    for p in pair["brain"].parameters():
        p.grad.clamp_(-1.0, 1.0)
    optimizer.step()
    np.testing.assert_allclose(float(loss_single), float(loss_sharded), rtol=1e-6)
    for (name, a), b_ in zip(brain.named_parameters(), pair["brain"].parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b_.detach().numpy(), atol=1e-6,
                                   err_msg=name)


def _tapnet_windows(n, seed=4):
    from ivosw_tpu_torch.interact.robot import ScribbleRobot
    from ivosw_tpu_torch.train.train_vos import sample_windows
    from ivosw_tpu_torch.utils.misc import set_random_seed

    registry = SequenceRegistry.synthetic(
        ["dpv-a", "dpv-b"], num_frames=6, image_size=(64, 48), num_objects=1,
        split="train", seed=seed,
    )
    rng = set_random_seed(0)
    stream = sample_windows(registry, registry.subset("train"), rng, 3, ScribbleRobot(seed=0))
    windows = [next(stream) for _ in range(n)]
    return {k: np.stack([w[k] for w in windows]) for k in windows[0]}


def test_dp_vos_train_step_matches_single_device():
    """The windows-sharded VOS step gives the same parameters and loss as
    the same stacked batch on one device (JAX test's bounds; SGD keeps the
    parameter change linear in the gradient)."""
    from ivosw_tpu_torch.models.vos.tapnet import TAPNet, init_tapnet_params
    from ivosw_tpu_torch.train.train_vos import tapnet_window_loss, upload_window, vos_train_step_dp

    batch = _tapnet_windows(8)
    params = init_tapnet_params(0)
    net1, net2 = TAPNet(), TAPNet()
    net1.load_state_dict(params)
    net2.load_state_dict(params)
    net1.train(), net2.train()
    loss_single = vos_train_step_dp([net1], torch.optim.SGD(net1.parameters(), lr=1e-2),
                                    [upload_window(batch, "cpu")], tapnet_window_loss)
    mesh = make_mesh(devices=CPU8)
    replicas = replicate(mesh, net2)
    optimizer = torch.optim.SGD(net2.parameters(), lr=1e-2)
    loss_sharded = vos_train_step_dp(replicas, optimizer, shard_batch(mesh, batch),
                                     tapnet_window_loss)
    np.testing.assert_allclose(float(loss_single), float(loss_sharded), rtol=2e-4)
    for (name, a), b_ in zip(net1.named_parameters(), net2.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b_.detach().numpy(), atol=5e-5,
                                   err_msg=name)
    # the replicas take the stepped parameters at the next step's start
    vos_train_step_dp(replicas, optimizer, shard_batch(mesh, batch), tapnet_window_loss)
    before = [p.detach().clone() for p in replicas[7].parameters()]
    vos_train_step_dp(replicas, torch.optim.SGD(net2.parameters(), lr=0.0),
                      shard_batch(mesh, batch), tapnet_window_loss)
    for p0, p7 in zip(net2.parameters(), replicas[7].parameters()):
        assert torch.equal(p0, p7)
    assert any(not torch.equal(a, p) for a, p in zip(before, replicas[7].parameters()))


def test_dp_vos_training_runs_and_learns(tmp_path):
    """run(dp_windows=8) over an 8-way mesh trains, writes the checkpoint,
    and its first step's loss is the one-device B-window step's; the
    dp_windows % mesh guard raises."""
    from ivosw_tpu_torch.train import train_vos

    registry = SequenceRegistry.synthetic(
        ["dpr-a", "dpr-b"], num_frames=6, image_size=(64, 48), num_objects=1,
        split="train", seed=5,
    )
    mesh = make_mesh(("data",), devices=CPU8)
    cfg = Config(seed=0)
    cfg.data.subset = "train"
    cfg.ckpt_dir = str(tmp_path / "wdp")
    stats = train_vos.run(cfg, registry=registry, num_steps=3, window=3, lr=3e-4,
                          save_every=3, dp_windows=8, mesh=mesh, device="cpu")
    assert np.isfinite(stats["loss_avg"]) and len(stats["losses"]) == 3
    assert (tmp_path / "wdp" / "tapnet.pt").exists()
    cfg.ckpt_dir = str(tmp_path / "one")
    one = train_vos.run(cfg, registry=registry, num_steps=1, window=3, lr=3e-4,
                        save_every=3, dp_windows=8, device="cpu")
    np.testing.assert_allclose(stats["losses"][0], one["losses"][0], rtol=2e-4)

    with pytest.raises(ValueError, match="multiple of the data-mesh"):
        train_vos.run(cfg, registry=registry, num_steps=1, window=3, dp_windows=3,
                      mesh=mesh, device="cpu")


def test_assess_param_shardings_rule(jax_assess_variables):
    """Output channels over 'model' when divisible, as the JAX rule; the
    placed shards reassemble the state dict."""
    import jax

    from ivosw_tpu.parallel.mesh import assess_param_shardings as jax_rule
    from ivosw_tpu.parallel.mesh import make_mesh as jax_make_mesh

    mesh = make_mesh(("data", "model"), devices=CPU8)
    state = _port_assess(jax_assess_variables, fold=False).state_dict()
    specs = assess_param_shardings(mesh, state)
    assert specs["conv1.weight"] == ("model", None, None, None)
    assert specs["fc1.weight"] == () and specs["bn1.running_var"] == ("model",)
    # the same tensors split as in the JAX package's rule on one device per shard
    jax_specs = jax_rule(jax_make_mesh(("data", "model"), shape=(1, 1),
                                       devices=jax.devices()[:1]), jax_assess_variables)
    assert jax_specs["params"]["conv1"]["kernel"].spec[-1] == "model"
    parts = apply_shardings(mesh, state, specs)
    assert len(parts) == 4 and parts[1]["conv1.weight"].shape == (16, 3, 7, 7)
    torch.testing.assert_close(torch.cat([p["conv1.weight"] for p in parts]),
                               state["conv1.weight"], rtol=0, atol=0)
    torch.testing.assert_close(parts[3]["fc1.weight"], state["fc1.weight"], rtol=0, atol=0)


@pytest.mark.parametrize("method", ["worst", "random", "ours"])
def test_dp_eval_sweep_equals_single_device(tmp_path, method):
    """The 8-shard sweep reproduces the one-device curve (and picks), which
    is the JAX package's evaluate's. ``ours`` passes a seeded agent: each
    shard picks with its own copy, and the caller's agent is left as it
    was."""
    import jax

    from ivosw_tpu.core.config import Config as JaxConfig
    from ivosw_tpu.data.registry import SequenceRegistry as JaxRegistry
    from ivosw_tpu.eval.eval_agent import evaluate as jax_evaluate
    from ivosw_tpu.models.agent import Agent as JaxAgent
    from ivosw_tpu.models.vos.fake import FakeVOS as JaxFakeVOS
    from ivosw_tpu_torch.models.agent import Agent
    from ivosw_tpu_torch.utils.convert import brain_state_dict_from_numpy
    from ivosw_tpu_torch.eval.eval_agent import evaluate, evaluate_dp
    from ivosw_tpu_torch.interact.session import InteractiveSession
    from ivosw_tpu_torch.models.vos.fake import FakeVOS

    names = ["p-a", "p-b", "p-c"]
    registry = SequenceRegistry.synthetic(names, num_frames=6, image_size=(48, 40),
                                          num_objects=2, seed=5)
    setting = "wild" if method == "random" else "oracle"
    cfg = Config(seed=0, setting=setting, method=method, vos="fake")
    cfg.davis_interactive.allow_repeat = 0
    jax_cfg = JaxConfig(seed=0, setting=setting, method=method, vos="fake")
    jax_cfg.davis_interactive.allow_repeat = 0
    jax_agent, agents = None, [None] * 2
    if method == "ours":  # the JAX agent's seeded Brain in the port's agents
        jax_agent = JaxAgent(jax_cfg, seed=0)
        agents = [Agent(cfg, seed=0, device="cpu") for _ in range(2)]
        for agent in agents:
            agent.brain.load_state_dict(brain_state_dict_from_numpy(
                jax.tree.map(np.asarray, jax_agent.params)))

    picks = {}  # (in a shard thread, sequence, scribble) → the rounds' picks
    submit = InteractiveSession.submit_masks

    def recording(self, masks, next_scribble_frame_candidates=None, **kw):
        shard = threading.current_thread() is not threading.main_thread()
        picks.setdefault((shard, *self.current_sample), []).append(next_scribble_frame_candidates)
        return submit(self, masks, next_scribble_frame_candidates=next_scribble_frame_candidates,
                      **kw)

    InteractiveSession.submit_masks = recording
    try:
        single = evaluate(cfg, registry, FakeVOS(registry, max_quality=0.8), agent=agents[0],
                          max_nb_interactions=3, report_save_dir=str(tmp_path / "single"),
                          vos_name="fake", device="cpu")
        rng_state = agents[1] and agents[1].host_rng.bit_generator.state
        sharded = evaluate_dp(cfg, registry, lambda d: FakeVOS(registry, max_quality=0.8),
                              n_shards=8, devices=CPU8, agent=agents[1], max_nb_interactions=3,
                              report_save_dir=str(tmp_path / "dp"), vos_name="fake")
    finally:
        InteractiveSession.submit_masks = submit
    np.testing.assert_allclose(sharded["curve"]["J_AND_F"], single["curve"]["J_AND_F"],
                               atol=1e-12)
    assert sharded["auc"] == pytest.approx(single["auc"], abs=1e-12)
    assert sharded["n_shards"] == 8
    with open(tmp_path / "dp" / "summary.json") as fp:
        assert json.load(fp)["auc"] == pytest.approx(single["auc"], abs=1e-12)
    one = {k[1:]: v for k, v in picks.items() if not k[0]}
    dp = {k[1:]: v for k, v in picks.items() if k[0]}
    assert one and one == dp
    if method == "ours":
        assert agents[0].steps_done > 0 and agents[1].steps_done == 0
        assert agents[1].host_rng.bit_generator.state == rng_state

    jax_registry = JaxRegistry.synthetic(names, num_frames=6, image_size=(48, 40),
                                         num_objects=2, seed=5)
    ref = jax_evaluate(jax_cfg, jax_registry, JaxFakeVOS(jax_registry, max_quality=0.8),
                       agent=jax_agent, max_nb_interactions=3,
                       report_save_dir=str(tmp_path / "jax"), vos_name="fake")
    np.testing.assert_allclose(sharded["curve"]["J_AND_F"], ref["curve"]["J_AND_F"],
                               atol=1e-12)


def test_frame_sharded_score_clip_matches_single_device(jax_assess_variables):
    """SP: T sharded over 8 devices equals the unsharded scores, with a
    ragged T (11 over 8 shards) that forces padding, for the unfolded and
    the BN-folded net; and both equal the JAX package's score_clip (JAX
    test's bound 2e-2)."""
    import jax.numpy as jnp

    from ivosw_tpu.models.assess import score_clip as jax_score_clip
    from ivosw_tpu.models.assess import score_clip_folded as jax_score_clip_folded
    from ivosw_tpu.models.fold import fold_assess_variables as jax_fold
    from ivosw_tpu_torch.models.assess import score_clip

    mesh = make_mesh(("data",), devices=CPU8)
    rng = np.random.default_rng(3)
    t, o, h, w = 11, 2, 40, 48
    frames = rng.random((t, h, w, 3)).astype(np.float32)
    probs = rng.random((t, o, h, w)).astype(np.float32)
    obj_valid = np.ones((o,), np.float32)
    args = [torch.from_numpy(x) for x in (frames, probs, obj_valid)]

    for fold in (False, True):
        net = _port_assess(jax_assess_variables, fold)
        single = score_clip(net, *args)
        sp = frame_sharded_score_clip(mesh, net, *args)
        assert sp.shape == (t, o)
        np.testing.assert_allclose(sp.numpy(), single.numpy(), atol=2e-2)
        variables = jax_fold(jax_assess_variables) if fold else jax_assess_variables
        score = jax_score_clip_folded if fold else jax_score_clip
        ref = np.asarray(score(variables, jnp.asarray(frames), jnp.asarray(probs),
                               jnp.asarray(obj_valid)))
        np.testing.assert_allclose(sp.numpy(), ref, atol=2e-2)


def test_eval_sp_shards_production_path(jax_assess_variables):
    """eval_sp_shards > 1 through recommend_frame: the same pick and
    predicted-quality state (within 2e-2) as unsharded and as the JAX
    package's recommend_frame; DP with SP is refused at the entry point."""
    from ivosw_tpu.core.config import Config as JaxConfig
    from ivosw_tpu.interact import recommend as jax_recommend
    from ivosw_tpu_torch.eval.eval_agent import build_and_evaluate
    from ivosw_tpu_torch.interact import recommend

    rng = np.random.default_rng(11)
    t, o, h, w = 6, 2, 40, 48
    frames = rng.random((t, h, w, 3)).astype(np.float32)
    probs = np.zeros((t, o + 1, h, w), dtype=np.float32)
    probs[:, 1, 8:24, 10:36] = 0.9
    probs[:, 2, 20:36, 24:44] = 0.8
    net = _port_assess(jax_assess_variables, fold=False)

    def pick(module, cfg, model):
        state = np.zeros((t,), dtype=np.float32)
        frame = module.recommend_frame(
            cfg, model, None, t, o, frames, probs,
            new_masks_quality=np.zeros((t,), np.float32),
            prev_frames=[0], annotated_frames_list=[0], mask_quality=state,
            first_frame=0, max_nb_interactions=3, rng=np.random.default_rng(0),
        )
        return frame, state

    picks, states = [], []
    for shards in (1, 8):
        cfg = Config(setting="wild", method="worst", eval_sp_shards=shards)
        cfg.assess_net.score_chunk = 8  # a small block: cheap on the CPU
        p, s = pick(recommend, cfg, net)
        picks.append(p)
        states.append(s)
    assert picks[0] == picks[1]
    np.testing.assert_allclose(states[1], states[0], atol=2e-2)
    jax_cfg = JaxConfig(setting="wild", method="worst")
    jax_cfg.assess_net.score_chunk = 8
    jax_pick, jax_state = pick(jax_recommend, jax_cfg, jax_assess_variables)
    assert picks[1] == jax_pick
    np.testing.assert_allclose(states[1], jax_state, atol=2e-2)

    bad = Config(eval_dp_shards=2, eval_sp_shards=2, vos="fake")
    with pytest.raises(ValueError, match="exclusive"):
        build_and_evaluate(bad)


def test_sp_mesh_device_guards():
    """``_sp_mesh`` caches per concrete device set, takes copies of the CPU
    for a CPU run, refuses a CUDA run with too few cards, and refuses to
    build a mesh inside a data-parallel shard."""
    from ivosw_tpu_torch.interact import recommend

    cpu = torch.device("cpu")
    mesh = recommend._sp_mesh(2, cpu)
    assert [str(d) for d in mesh.devices.flat] == ["cpu", "cpu"]
    assert recommend._sp_mesh(2, cpu) is mesh  # cache hit on the same devices
    assert recommend._sp_mesh(1, cpu) is None
    with pytest.raises(ValueError, match=f"only {torch.cuda.device_count()} CUDA"):
        recommend._sp_mesh(max(2, torch.cuda.device_count() + 1), torch.device("cuda", 0))
    with recommend.data_parallel_shard():
        with pytest.raises(ValueError, match="data-parallel shard"):
            recommend._sp_mesh(2, cpu)
        assert recommend._sp_mesh(1, cpu) is None
    assert recommend._sp_mesh(2, cpu) is mesh  # the flag ends with the shard


def test_build_and_evaluate_dp_equals_single_device(tmp_path, monkeypatch):
    """``eval_dp_shards=2`` through the CLI's wiring runs evaluate_dp (two
    CPU shards) and writes the one-device curve (1e-12)."""
    from ivosw_tpu_torch.eval import eval_agent
    from torch_dataset_trees import write_mini_davis

    root = write_mini_davis(str(tmp_path / "mini_davis"))
    monkeypatch.chdir(tmp_path)
    summaries = {}
    calls = []
    dp = eval_agent.evaluate_dp
    monkeypatch.setattr(eval_agent, "evaluate_dp",
                        lambda *a, **k: calls.append(k["devices"]) or dp(*a, **k))
    for shards in (1, 2):
        cfg = Config(dataset="davis", vos="fake", setting="wild", method="random",
                     eval_rounds=3, eval_dp_shards=shards)
        cfg.data.root_dir_davis = root
        summaries[shards] = eval_agent.build_and_evaluate(cfg, overwrite=True, device="cpu")
    assert calls == [[torch.device("cpu")] * 2] and summaries[2]["n_shards"] == 2
    np.testing.assert_allclose(summaries[2]["curve"]["J_AND_F"],
                               summaries[1]["curve"]["J_AND_F"], atol=1e-12)


def test_launch_counters_exact_under_threads(monkeypatch, tmp_path):
    """Kernel launch counts stay exact when shard threads launch at once:
    the locked counter under eight threads, and evaluate_dp's two CPU
    shards each counting its fused-box calls through it (the CPU computes
    the plain version, so the test counts it as the CUDA branch does)."""
    from ivosw_tpu_torch.eval.eval_agent import evaluate_dp
    from ivosw_tpu_torch.kernels import roi_crop
    from ivosw_tpu_torch.models.assess import init_assess_net
    from ivosw_tpu_torch.models.vos.fake import FakeVOS

    monkeypatch.setattr(roi_crop.roi_crop_pairs, "launches", 0)

    def hammer():
        for _ in range(20000):
            roi_crop._count_launch(roi_crop.roi_crop_pairs)

    threads = [threading.Thread(target=hammer) for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert roi_crop.roi_crop_pairs.launches == 8 * 20000

    plain = roi_crop.roi_crop_pairs_fusedbox_reference
    by_thread = {}

    def counted(*args, **kwargs):
        roi_crop._count_launch(roi_crop.roi_crop_pairs_fusedbox)
        name = threading.current_thread().name
        by_thread[name] = by_thread.get(name, 0) + 1
        return plain(*args, **kwargs)

    monkeypatch.setattr(roi_crop, "roi_crop_pairs_fusedbox_reference", counted)
    monkeypatch.setattr(roi_crop.roi_crop_pairs_fusedbox, "launches", 0)
    registry = SequenceRegistry.synthetic(["c-a"], num_frames=6, image_size=(48, 40),
                                          num_objects=2, seed=5)
    cfg = Config(seed=0, setting="wild", method="worst", vos="fake")
    cfg.assess_net.score_chunk = 8
    rounds = 2
    summary = evaluate_dp(cfg, registry, lambda d: FakeVOS(registry, max_quality=0.8),
                          devices=["cpu", "cpu"], assess_net=init_assess_net(0, fold=True),
                          max_nb_interactions=rounds, report_save_dir=str(tmp_path),
                          vos_name="fake")
    # one scoring chunk a round, every round; 3 samples: 2 on one shard, 1 on the other
    n_rounds = len(summary["report"])
    assert summary["n_shards"] == 2 and n_rounds == 3 * rounds
    assert sorted(by_thread.values()) == [rounds, 2 * rounds]
    assert roi_crop.roi_crop_pairs_fusedbox.launches == n_rounds
