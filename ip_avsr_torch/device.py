"""Device resolution for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU.  Without a
GPU they raise instead of quietly running the plain versions on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``; ``"cpu"`` must be asked for explicitly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "ip_avsr_torch runs on CUDA by default but no CUDA device is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf to a nested dict/list/tuple tree and the
    trees of the same structure in ``rest``; the structure is kept.  Leaves
    are visited in a fixed order: dict keys as inserted, sequences in
    order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_to(tree, device: torch.device):
    """Move every tensor of a nested dict/list/tuple parameter tree to
    ``device`` (structure and keys unchanged)."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree
