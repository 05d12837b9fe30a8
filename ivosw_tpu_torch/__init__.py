"""IVOS-W on PyTorch and CUDA: the port of ``ivosw_tpu`` to one NVIDIA H100.

The package keeps ``ivosw_tpu``'s module layout and public function names so
a reader finds each counterpart, and keeps its array layouts at public
functions: frames ``[T, H, W, 3]``, probabilities ``[T, O(+1), H, W]``, ROI
crops ``[T·O, S, S, C]``. It imports ``torch`` and never ``jax`` or
anything of ``ivosw_tpu``.

Device policy (:mod:`ivosw_tpu_torch.device`): entry points run on CUDA
unless the caller passes ``device="cpu"``; without a GPU they raise.

Subpackages
-----------
core      config dataclasses, ``key=value`` overrides, a YAML-free loader
data      scribble dicts, the in-memory registry, the demo clip generator,
          the replay pool
interact  interactive session, cv2-free scribble robot, frame recommendation
ops       J&F metrics (scipy), ROI geometry (torch)
kernels   hand-written CUDA kernels for Hopper and their plain versions
models    ResNet-50 AssessNet (+ BN folding), BiLSTM Brain, DQN agent, VOS
eval      interactive evaluation driver
train     AssessNet and agent training stages, the rollout loop
utils     seeding, meters, timers, weight conversion, agent checkpoints
"""

__version__ = "0.1.0"
