"""Multi-stream fusion: sum / adaptive-sum / concat.

Mirrors ip_avsr_tpu/ops/fusion.py: ``adasum`` scales each stream by one
learned scalar (``adacoeff{i}``, init 1.0) before summing.
"""

from __future__ import annotations

import torch

def init_adasum_params(n_streams: int, dtype=torch.float32) -> dict:
    return {f"adacoeff{i}": torch.tensor(1.0, dtype=dtype) for i in range(n_streams)}


def fuse(streams, fusiontype: str, adasum_params: dict | None = None) -> torch.Tensor:
    if fusiontype == "sum":
        out = streams[0]
        for s in streams[1:]:
            out = out + s
        return out
    if fusiontype == "adasum":
        if adasum_params is None:
            raise ValueError("adasum fusion requires adasum params")
        out = None
        for i, s in enumerate(streams):
            scaled = s * adasum_params[f"adacoeff{i}"]
            out = scaled if out is None else out + scaled
        return out
    if fusiontype == "concat":
        return torch.cat(list(streams), dim=-1)
    raise ValueError(f"Unsupported fusion type: {fusiontype!r}")


def fused_dim(stream_dims, fusiontype: str) -> int:
    if fusiontype == "concat":
        return int(sum(stream_dims))
    dims = set(int(d) for d in stream_dims)
    if len(dims) != 1:
        raise ValueError(f"{fusiontype} fusion requires equal stream dims, got {stream_dims}")
    return dims.pop()
