"""Evaluation: classification rate and confusion matrices.

Host-side numpy copies of ip_avsr_tpu/train/evaluation.py
(``confusion_matrix``, ``evaluate_majority_vote``, ``evaluate_last_step``,
``cr_from_confusion``, ``plot_confusion_matrix``): per-frame argmax votes
over valid frames, majority wins (per-step heads), or the utterance's argmax
(last-step heads); each returns (classification rate, confusion matrix,
predictions).  ``confusion_on_device`` counts a confusion matrix on the
trainer's device as one one-hot product.
"""

from __future__ import annotations

import numpy as np
import torch

from ip_avsr_torch.ops.voting import masked_majority_vote


def confusion_matrix(targets, predictions, num_classes: int) -> np.ndarray:
    cm = np.zeros((num_classes, num_classes), dtype=int)
    np.add.at(cm, (np.asarray(targets, dtype=int), np.asarray(predictions, dtype=int)), 1)
    return cm


def evaluate_majority_vote(probs, y, mask):
    """probs (B, T, C) per-timestep softmax; y (B,) targets; mask (B, T)."""
    probs = np.asarray(probs)
    preds = masked_majority_vote(probs, mask)
    y = np.asarray(y).reshape(-1)
    cr = float(np.mean(preds == y))
    return cr, confusion_matrix(y, preds, probs.shape[-1]), preds


def evaluate_last_step(probs, y):
    """probs (B, C) utterance-level softmax; y (B,) targets."""
    probs = np.asarray(probs)
    preds = np.argmax(probs, axis=-1)
    y = np.asarray(y).reshape(-1)
    cr = float(np.mean(preds == y))
    return cr, confusion_matrix(y, preds, probs.shape[-1]), preds


def confusion_on_device(preds: torch.Tensor, y: torch.Tensor, valid: torch.Tensor,
                        num_classes: int) -> torch.Tensor:
    """(C, C) float32 confusion counts from (B,) int predictions and targets
    on the device, rows with ``valid`` 0 left out: one one-hot product, so
    only the counts, not the predictions, need to reach the host."""
    oh_t = torch.nn.functional.one_hot(y.long(), num_classes).float() * valid[:, None]
    oh_p = torch.nn.functional.one_hot(preds.long(), num_classes).float()
    return oh_t.T @ oh_p


def cr_from_confusion(conf) -> float:
    conf = np.asarray(conf)
    total = conf.sum()
    return float(np.trace(conf) / total) if total else 0.0


def plot_confusion_matrix(cm, classnames, fmt: str = "pipe") -> str:
    """Render a confusion matrix as a markdown ('pipe') or LaTeX table."""
    cm = np.asarray(cm)
    header = list(classnames)
    if fmt == "pipe":
        lines = ["| |" + "|".join(header) + "|",
                 "|" + "---|" * (len(header) + 1)]
        for name, row in zip(header, cm):
            lines.append("|" + name + "|" + "|".join(str(v) for v in row) + "|")
        return "\n".join(lines)
    if fmt == "latex":
        lines = ["\\begin{tabular}{l" + "r" * len(header) + "}",
                 " & " + " & ".join(header) + " \\\\ \\hline"]
        for name, row in zip(header, cm):
            lines.append(name + " & " + " & ".join(str(v) for v in row) + " \\\\")
        lines.append("\\end{tabular}")
        return "\n".join(lines)
    raise ValueError(f"unknown fmt: {fmt}")
