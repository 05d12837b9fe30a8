"""The port stands alone: it imports with JAX blocked, names nothing of the
JAX package, and its entry points refuse to fall back to the CPU."""

import os
import pkgutil
import re
import subprocess
import sys

import pytest
import torch

import ivosw_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "ivosw_tpu_torch")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The backbones' seeded inits are large elementwise ops: under the
    tier-1 run's six workers more intra-op threads only spin."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _port_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages([PORT], prefix="ivosw_tpu_torch.")
    )


def test_every_module_imports_with_jax_blocked():
    """A fresh interpreter with jax/flax/optax/orbax (and cv2, PIL, yaml,
    torchvision) made unimportable imports every module of the port."""
    blocked = ["jax", "jaxlib", "flax", "optax", "orbax", "cv2", "PIL", "yaml", "torchvision"]
    code = (
        "import sys, importlib\n"
        f"for name in {blocked!r}:\n"
        "    sys.modules[name] = None\n"
        f"for mod in {_port_modules()!r}:\n"
        "    importlib.import_module(mod)\n"
        "leaked = [m for m in sys.modules if m.split('.')[0] == 'ivosw_tpu']\n"
        "assert not leaked, leaked\n"
        "print('IMPORTED', len(sys.modules))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "IMPORTED" in proc.stdout


@pytest.mark.parametrize(
    "pattern",
    [
        r"\bivosw_tpu\.",
        r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|orbax)\b",
        r"^\s*(import|from)\s+(cv2|PIL|yaml)\b",
        r"^\s*(import|from)\s+torchvision\b",
    ],
)
def test_no_file_names_the_jax_package(pattern):
    """Grep every source of the port (CUDA and host C++ included) and
    chip_smoke.py."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith((".py", ".cu", ".cpp"))]
    rx = re.compile(pattern, re.MULTILINE)
    hits = [f for f in files if rx.search(open(f).read())]
    assert not hits, hits


@pytest.mark.parametrize("module", [
    "ivosw_tpu_torch.utils.torch_import",
    "ivosw_tpu_torch.ops.metrics_native",
    "ivosw_tpu_torch.parallel.mesh",
    "ivosw_tpu_torch.utils.visualize",
])
def test_the_last_slice_modules_are_walked(module):
    """The modules of the last slice are among those the checks above
    import with JAX blocked and grep; their C++ source is grepped too."""
    assert module in _port_modules()
    assert os.path.exists(os.path.join(PORT, "csrc", "host", "metrics.cpp"))


def test_entry_points_refuse_cpu_fallback(monkeypatch):
    """device=None means CUDA: without a GPU the entry points raise."""
    from ivosw_tpu_torch.core.config import Config
    from ivosw_tpu_torch.data.registry import SequenceRegistry
    from ivosw_tpu_torch.device import resolve_device
    from ivosw_tpu_torch.eval.eval_agent import build_and_evaluate, evaluate
    from ivosw_tpu_torch.models.agent import Agent
    from ivosw_tpu_torch.models.vos.fake import FakeVOS

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config(phase="eval", setting="wild", method="ours", vos="fake", dataset="demo")
    reg = SequenceRegistry.synthetic(["a"], num_frames=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Agent(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate(cfg, reg, FakeVOS(reg))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_and_evaluate(cfg)
    assert resolve_device("cpu") == torch.device("cpu")


def test_training_entry_points_refuse_cpu_fallback(monkeypatch):
    """The trainers resolve their device like every entry point: without a
    GPU they raise; an ImageNet trunk that is not there raises
    FileNotFoundError (the JAX package's message)."""
    from ivosw_tpu_torch.core.config import Config
    from ivosw_tpu_torch.data.registry import SequenceRegistry
    from ivosw_tpu_torch.train import pretrain_assess, train_assess

    reg = SequenceRegistry.synthetic(["a"], num_frames=4, split="train")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pretrain_assess.run(Config(), registry=reg, num_steps=1, batch_size=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_assess.run(Config(), registry=reg, save_result_dir="unused")
    cfg = Config()
    cfg.assess_net.imagenet_ckpt = "resnet50.pth"
    with pytest.raises(FileNotFoundError, match="'resnet50.pth' is not a readable torchvision"):
        pretrain_assess.run(cfg, registry=reg, num_steps=1, batch_size=1, device="cpu")


def test_models_on_another_device_raise():
    """evaluate and predict_clip_quality never copy across devices: a net,
    a Brain or a frame tensor on another device than the run's raises (the
    round would otherwise run, and be timed, on the host)."""
    import numpy as np

    from ivosw_tpu_torch.core.config import Config
    from ivosw_tpu_torch.data.registry import SequenceRegistry
    from ivosw_tpu_torch.eval.eval_agent import evaluate
    from ivosw_tpu_torch.interact.recommend import predict_clip_quality
    from ivosw_tpu_torch.models.agent import Agent
    from ivosw_tpu_torch.models.assess import AssessNet
    from ivosw_tpu_torch.models.vos.fake import FakeVOS

    cfg = Config(phase="eval", setting="wild", method="ours", vos="fake", dataset="demo")
    reg = SequenceRegistry.synthetic(["a"], num_frames=4)
    with torch.device("meta"):
        meta_net = AssessNet(fold=True)
    with pytest.raises(ValueError, match="assess_net is on meta"):
        evaluate(cfg, reg, FakeVOS(reg), assess_net=meta_net, device="cpu")
    with pytest.raises(ValueError, match="agent is on cpu"):
        evaluate(cfg, reg, FakeVOS(reg), agent=Agent(cfg, device="cpu"), device="meta")
    frames = np.zeros((4, 8, 8, 3), np.float32)
    probs = np.zeros((4, 2, 8, 8), np.float32)
    with pytest.raises(ValueError, match="all_F is on cpu"):
        predict_clip_quality(meta_net, torch.from_numpy(frames), probs, 1)
    with pytest.raises(ValueError, match="all_P is on cpu"):
        predict_clip_quality(meta_net, frames, torch.from_numpy(probs), 1)


def test_kernel_wrapper_refuses_other_devices():
    """On the CPU the wrapper computes the plain version; a tensor on any
    other device raises instead of falling back."""
    from ivosw_tpu_torch.kernels.roi_crop import roi_crop_pairs_fusedbox

    frames = torch.zeros((1, 8, 8, 3), device="meta")
    probs = torch.zeros((1, 1, 8, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        roi_crop_pairs_fusedbox(frames, probs, 4)
    before = roi_crop_pairs_fusedbox.launches
    out = roi_crop_pairs_fusedbox(torch.zeros((1, 8, 8, 3)), torch.zeros((1, 1, 8, 8)), 4)
    assert out.shape == (1, 4, 4, 4) and roi_crop_pairs_fusedbox.launches == before


def test_unported_backbones_name_their_slice(tmp_path):
    """Every backbone of the JAX package builds: tapnet, matchnet and ipnet
    on the CPU when asked, with their prob maps in bf16 under
    assess_net.bf16_inputs; without a GPU and without device="cpu" they
    raise rather than fall back to the CPU. An unknown name raises
    NotImplementedError naming it."""
    from ivosw_tpu_torch.core.config import Config
    from ivosw_tpu_torch.eval.backbones import build_backbone
    from ivosw_tpu_torch.models.vos.ipnet import IPNetAdapter
    from ivosw_tpu_torch.models.vos.matchnet import MatchNetAdapter
    from ivosw_tpu_torch.models.vos.tapnet import TAPNetAdapter

    with pytest.raises(NotImplementedError, match="nonet"):
        build_backbone(Config(vos="nonet"), None, "cpu")
    for name, cls in (("tapnet", TAPNetAdapter), ("matchnet", MatchNetAdapter),
                      ("ipnet", IPNetAdapter)):
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                build_backbone(Config(vos=name), None)
        for bf16 in (False, True):
            cfg = Config(vos=name, ckpt_dir=str(tmp_path))
            cfg.assess_net.bf16_inputs = bf16
            adapter = build_backbone(cfg, None, "cpu")
            assert isinstance(adapter, cls) and adapter.name == name
            assert adapter.device == torch.device("cpu")
            assert adapter.qa_dtype == (torch.bfloat16 if bf16 else torch.float32)
            assert next(adapter.net.parameters()).device.type == "cpu"
    assert ivosw_tpu_torch.__version__
