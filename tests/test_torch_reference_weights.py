"""Reference and torchvision weights (``ivosw_tpu_torch/utils/torch_import.py``)
against the JAX package's converters (``ivosw_tpu/utils/torch_import.py``).

Seeded state dicts in the reference's layouts (its ``agent.pt`` Brain, its
``assess_net.pt`` AssessNet with the dead ``conv1_m``/``conv1_n`` stems and
``num_batches_tracked``) and in torchvision's ``resnet50`` layout are built
here, so nothing is downloaded. Both packages convert the same dict: Brain
Q-values agree within 1e-6, float32 AssessNet scores within 1e-4 (two
float32 convolution libraries over 53 layers), with ``fc1`` copied across
for the torchvision case (each package draws its own seeded head). Then the
loaders and their users: ``restore_agent``, ``build_and_evaluate``,
``train_assess.build_net``, and files in neither layout."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivosw_tpu.models.assess import AssessNet as JaxAssessNet
from ivosw_tpu.models.brain import brain_forward as jax_brain_forward
from ivosw_tpu.utils import torch_import as jax_import
from ivosw_tpu_torch.core.config import Config
from ivosw_tpu_torch.models.assess import AssessNet
from ivosw_tpu_torch.models.brain import Brain, brain_forward
from ivosw_tpu_torch.utils import torch_import

Q_ATOL = 1e-6
F32_TOL = 1e-4
STAGES = {2: (64, 3), 3: (128, 4), 4: (256, 6), 5: (512, 3)}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _t(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))


def _bn(rng, sd, prefix, c):
    sd[prefix + "weight"] = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32))
    sd[prefix + "bias"] = torch.from_numpy(rng.uniform(-0.2, 0.2, c).astype(np.float32))
    sd[prefix + "running_mean"] = torch.from_numpy(rng.uniform(-0.2, 0.2, c).astype(np.float32))
    sd[prefix + "running_var"] = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32))
    sd[prefix + "num_batches_tracked"] = torch.tensor(7)


def _conv(rng, sd, key, cout, cin, k):
    sd[key] = _t(rng, cout, cin, k, k, scale=np.sqrt(2.0 / (cout * k * k)))


def _resnet_trunk(rng, sd, block_prefix):
    cin = 64
    for stage, (width, blocks) in STAGES.items():
        for i in range(blocks):
            p = block_prefix(stage, i)
            c_in = cin if i == 0 else width * 4
            _conv(rng, sd, p + "conv1.weight", width, c_in, 1)
            _conv(rng, sd, p + "conv2.weight", width, width, 3)
            _conv(rng, sd, p + "conv3.weight", width * 4, width, 1)
            for j, c in ((1, width), (2, width), (3, width * 4)):
                _bn(rng, sd, p + f"bn{j}.", c)
            if i == 0:
                _conv(rng, sd, p + "downsample.0.weight", width * 4, c_in, 1)
                _bn(rng, sd, p + "downsample.1.", width * 4)
        cin = width * 4


def reference_brain(seed=0, prefix=""):
    rng = np.random.default_rng(seed)
    sd = {}
    for name, (o, i) in (("encoder_fc1", (128, 2)), ("encoder_fc2", (128, 128)),
                         ("decoder_fc1", (128, 256)), ("decoder_fc2", (1, 128))):
        sd[f"{prefix}{name}.weight"] = _t(rng, o, i, scale=1 / np.sqrt(i))
        sd[f"{prefix}{name}.bias"] = _t(rng, o, scale=0.1)
    for name in ("weight_ih", "weight_hh"):
        sd[f"{prefix}lstm_cell.{name}"] = _t(rng, 512, 128, scale=1 / np.sqrt(128))
    for name in ("bias_ih", "bias_hh"):  # dropped by both converters
        sd[f"{prefix}lstm_cell.{name}"] = _t(rng, 512, scale=0.1)
    return sd


def reference_assess(seed=0):
    rng = np.random.default_rng(seed)
    e = "Encoder."
    sd = {}
    _conv(rng, sd, e + "conv1.weight", 64, 3, 7)
    _conv(rng, sd, e + "conv1_p.weight", 64, 1, 7)
    _conv(rng, sd, e + "conv1_m.weight", 64, 1, 7)  # dead stems of the reference
    _conv(rng, sd, e + "conv1_n.weight", 64, 1, 7)
    _bn(rng, sd, e + "bn1.", 64)
    _resnet_trunk(rng, sd, lambda stage, i: f"{e}res{stage}.{i}.")
    sd[e + "mean"] = torch.tensor([0.485, 0.456, 0.406]).view(1, 3, 1, 1)
    sd[e + "std"] = torch.tensor([0.229, 0.224, 0.225]).view(1, 3, 1, 1)
    sd["fc1.weight"] = _t(rng, 1, 2048, scale=1 / np.sqrt(2048))
    sd["fc1.bias"] = _t(rng, 1, scale=0.1)
    return sd


def torchvision_resnet50(seed=0):
    rng = np.random.default_rng(seed)
    sd = {}
    _conv(rng, sd, "conv1.weight", 64, 3, 7)
    _bn(rng, sd, "bn1.", 64)
    _resnet_trunk(rng, sd, lambda stage, i: f"layer{stage - 1}.{i}.")
    sd["fc.weight"] = _t(rng, 1000, 2048, scale=0.01)
    sd["fc.bias"] = _t(rng, 1000, scale=0.01)
    return sd


@pytest.fixture(scope="module")
def crops():
    rng = np.random.default_rng(1)
    return (rng.random((2, 256, 256, 3), dtype=np.float32),
            rng.random((2, 256, 256, 1), dtype=np.float32))


def _brain_q(state):
    brain = Brain()
    brain.load_state_dict(state)
    x = np.random.default_rng(2).random((3, 25, 2)).astype(np.float32)
    mask = np.ones((3, 25), np.float32)
    mask[1, 20:] = 0
    return x, mask, brain_forward(brain.eval(), torch.from_numpy(x), torch.from_numpy(mask))


def _port_scores(state, crops):
    net = AssessNet(dtype=torch.float32)
    net.load_state_dict(state)
    with torch.no_grad():
        return net.eval()(*(torch.from_numpy(c) for c in crops)).numpy()


@pytest.mark.parametrize("prefix", ["", "module."])
def test_reference_brain_q_values_match_jax(prefix):
    sd = reference_brain(0, prefix)
    x, mask, q = _brain_q(torch_import.brain_state_dict_from_reference(sd))
    ref = np.asarray(jax_brain_forward(jax_import.brain_params_from_torch(sd), jnp.asarray(x),
                                       jnp.asarray(mask)))
    finite = mask > 0
    np.testing.assert_allclose(q.numpy()[finite], ref[finite], rtol=0, atol=Q_ATOL)
    assert np.isneginf(q.numpy()[~finite]).all()


def test_reference_assess_scores_match_jax(crops):
    sd = reference_assess(0)
    got = _port_scores(torch_import.assess_state_dict_from_reference(sd), crops)
    ref = np.asarray(JaxAssessNet(dtype=jnp.float32).apply(
        jax_import.assess_variables_from_torch(sd), *crops))
    assert got.shape == (2, 1)
    np.testing.assert_allclose(got, ref, rtol=F32_TOL, atol=F32_TOL)


def test_torchvision_resnet50_scores_match_jax(crops, tmp_path):
    """The ImageNet initialisation: trunk and stem from the file, conv1_p
    zero, fc1 seeded (copied from the JAX package's draw for the
    comparison); ``init_assess_from_imagenet`` reads the file."""
    sd = torchvision_resnet50(0)
    path = tmp_path / "resnet50.pth"
    torch.save(sd, path)
    variables = jax_import.init_assess_from_imagenet(str(path), seed=0)
    net = torch_import.init_assess_from_imagenet(str(path), seed=0)
    assert torch.count_nonzero(net.conv1_p.weight) == 0
    torch.testing.assert_close(net.trunk.res3.block0.downsample_conv.weight,
                               sd["layer2.0.downsample.0.weight"], rtol=0, atol=0)
    state = dict(net.state_dict())
    state["fc1.weight"] = torch.from_numpy(np.asarray(variables["params"]["fc1"]["kernel"]).T.copy())
    state["fc1.bias"] = torch.from_numpy(np.asarray(variables["params"]["fc1"]["bias"]).copy())
    got = _port_scores(state, crops)
    ref = np.asarray(JaxAssessNet(dtype=jnp.float32).apply(variables, *crops))
    np.testing.assert_allclose(got, ref, rtol=F32_TOL, atol=F32_TOL)


def test_loaders_take_both_layouts_and_refuse_others(tmp_path):
    brain_sd, assess_sd = reference_brain(3), reference_assess(3)
    torch.save(brain_sd, tmp_path / "agent.pt")
    torch.save(assess_sd, tmp_path / "assess_net.pt")
    brain = torch_import.load_agent_checkpoint_pt(str(tmp_path / "agent.pt"))
    assert set(brain) == set(Brain().state_dict())
    assess = torch_import.load_assess_checkpoint_pt(str(tmp_path / "assess_net.pt"))
    torch.testing.assert_close(assess["trunk.res4.block5.bn2.running_var"],
                               assess_sd["Encoder.res4.5.bn2.running_var"], rtol=0, atol=0)
    # the port's own layout passes through unchanged
    assert torch_import.brain_state_dict(brain) == brain
    assert torch_import.load_agent_checkpoint_pt(str(tmp_path / "missing.pt")) is None
    # neither layout: raise, naming the unexpected keys
    torch.save({"fc1.weight": torch.zeros(128, 2), "head.bias": torch.zeros(1)},
               tmp_path / "other.pt")
    with pytest.raises(RuntimeError, match=r"neither.*\['fc1.weight', 'head.bias'\]"):
        torch_import.load_agent_checkpoint_pt(str(tmp_path / "other.pt"))
    with pytest.raises(RuntimeError, match="head.bias"):
        torch_import.load_assess_checkpoint_pt(str(tmp_path / "other.pt"))
    with pytest.raises(RuntimeError, match="no key"):
        torch_import.init_assess_from_imagenet(str(tmp_path / "other.pt"))


def test_restore_agent_reads_a_reference_agent_pt(tmp_path):
    from ivosw_tpu_torch.models.agent import Agent
    from ivosw_tpu_torch.utils.checkpoint import restore_agent

    sd = reference_brain(4)
    torch.save(sd, tmp_path / "agent.pt")
    agent = Agent(Config(seed=0), device="cpu")
    assert restore_agent(agent, str(tmp_path)) and agent.steps_done == 0
    state = np.random.default_rng(5).random((25, 2)).astype(np.float32)
    direct = Agent(Config(seed=1), device="cpu")
    direct.brain.load_state_dict(torch_import.brain_state_dict_from_reference(sd))
    np.testing.assert_allclose(agent.q_values(state), direct.q_values(state), rtol=0, atol=0)
    for p, q in zip(agent.brain.parameters(), agent.target.parameters()):
        assert torch.equal(p, q)
    # epoch snapshots have no reference fallback
    torch.save(sd, tmp_path / "agent_epoch_2.pt")
    with pytest.raises(RuntimeError, match="state_dict"):
        restore_agent(agent, str(tmp_path), name="agent_epoch_2")


def test_build_and_evaluate_loads_reference_files(tmp_path, monkeypatch):
    """``ckpt_dir`` holding the reference's agent.pt and assess_net.pt:
    the evaluation runs with the converted Brain and the folded AssessNet
    of the converted state dict."""
    from ivosw_tpu_torch.eval import eval_agent
    from ivosw_tpu_torch.models.fold import fold_assess_variables

    brain_sd, assess_sd = reference_brain(6), reference_assess(6)
    torch.save(brain_sd, tmp_path / "agent.pt")
    torch.save(assess_sd, tmp_path / "assess_net.pt")
    seen = {}
    monkeypatch.setattr(eval_agent, "evaluate",
                        lambda cfg, registry, adapter, **kw: seen.update(kw) or {})
    monkeypatch.setattr("ivosw_tpu_torch.data.registry.registry_from_config", lambda cfg: None)
    cfg = Config(vos="fake", setting="wild", method="ours", ckpt_dir=str(tmp_path))
    eval_agent.build_and_evaluate(cfg, device="cpu")
    brain = torch_import.brain_state_dict_from_reference(brain_sd)
    for k, v in seen["agent"].brain.state_dict().items():
        torch.testing.assert_close(v, brain[k], rtol=0, atol=0)
    folded = fold_assess_variables(torch_import.assess_state_dict_from_reference(assess_sd))
    for k, v in seen["assess_net"].state_dict().items():
        torch.testing.assert_close(v, folded[k], rtol=0, atol=0)


def test_train_assess_builds_from_imagenet_ckpt(tmp_path):
    """``assess_net.imagenet_ckpt``: the net to train starts from the file;
    a missing or unreadable file raises the JAX package's message."""
    from ivosw_tpu_torch.train.train_assess import build_net

    sd = torchvision_resnet50(1)
    torch.save(sd, tmp_path / "resnet50.pth")
    cfg = Config(seed=3)
    cfg.assess_net.imagenet_ckpt = str(tmp_path / "resnet50.pth")
    net = build_net(cfg, None, torch.device("cpu"))
    assert net.dtype == torch.bfloat16
    torch.testing.assert_close(net.trunk.res5.block2.bn3.running_mean,
                               sd["layer4.2.bn3.running_mean"], rtol=0, atol=0)
    (tmp_path / "garbage.pth").write_bytes(b"not a checkpoint")
    for name in ("missing.pth", "garbage.pth"):
        cfg.assess_net.imagenet_ckpt = str(tmp_path / name)
        with pytest.raises(FileNotFoundError, match="is not a readable torchvision resnet50"):
            build_net(cfg, None, torch.device("cpu"))
