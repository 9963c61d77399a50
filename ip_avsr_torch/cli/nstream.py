"""The synthetic dataset of the N-stream trainer CLI.

Holds only the port's copy of ``synthesize_dataset``
(ip_avsr_tpu/cli/nstream.py:79), which the demo uses; the trainer CLI
itself comes with ROADMAP Queue 1 item 9.
"""

from __future__ import annotations

import numpy as np


def synthesize_dataset(n_videos, dim, classes, seed=0):
    """Fabricate a dataset dict with the reference's .mat schema.

    Sequence structure (lengths / targets / subjects) is drawn from a fixed
    seed so several synthetic streams stay frame-aligned; only the feature
    noise varies with ``seed``.
    """
    struct_rng = np.random.RandomState(0)
    rng = np.random.RandomState(seed + 1)
    lens = struct_rng.randint(10, 25, n_videos)
    y = struct_rng.randint(1, classes + 1, n_videos)  # MATLAB-style 1-based
    subjects = struct_rng.randint(1, 11, n_videos)  # per video, like the .mat schema
    frames = []
    for n, c in zip(lens, y):
        base = np.zeros(dim, np.float32)
        base[(c - 1) % dim] = 2.0
        frames.append(base + 0.5 * rng.randn(n, dim).astype(np.float32))
    return {
        "dataMatrix": np.concatenate(frames),
        "targetsVec": np.repeat(y, lens).reshape(-1, 1),  # per frame
        "subjectsVec": subjects.reshape(-1, 1),
        "videoLengthVec": lens.reshape(-1, 1),
    }
