"""PyTorch/CUDA port of ip_avsr_tpu for NVIDIA Hopper (H100).

The package mirrors ``ip_avsr_tpu``'s layout (``ops/``, ``models/``,
``serve.py``) and imports neither JAX nor ``ip_avsr_tpu``.  Entry points run
on ``cuda`` unless the caller passes ``device="cpu"``; every hand-written
kernel (``ops/kernels/``, sources in ``csrc/``) has a plain PyTorch version
beside it that runs only for tensors on the CPU.

The port covers the flagship trimodal AdeNet-v3: its inference path, from
raw uint8 ROI frames to class scores (``serve.make_trimodal_server``), and
its training step (``train.trainer.make_train_step``).
"""

from ip_avsr_torch.device import resolve_device

__all__ = ["resolve_device"]
