"""Evaluation metrics: numpy implementations of the reference's sklearn
pack (counterpart of wsi_hgnn_tpu/train/metrics.py).

  * binary AUC is computed from HARD predictions (the ROC of the argmax
    labels), the reference's quirk: it equals balanced accuracy, not a
    probability-ranked AUC;
  * multiclass AUC is one-vs-rest on probabilities, macro-averaged; a
    class absent from the targets is skipped (sklearn raises).
"""
from __future__ import annotations

import numpy as np


def accuracy(outputs: np.ndarray, targets: np.ndarray) -> float:
    """Argmax match rate."""
    return float(np.mean(outputs.argmax(axis=1) == targets))


def _prf_binary(targets, preds):
    tp = float(np.sum((preds == 1) & (targets == 1)))
    fp = float(np.sum((preds == 1) & (targets == 0)))
    fn = float(np.sum((preds == 0) & (targets == 1)))
    precision = tp / (tp + fp) if tp + fp > 0 else 0.0
    recall = tp / (tp + fn) if tp + fn > 0 else 0.0
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall > 0 else 0.0)
    return precision, recall, f1


def _prf_macro(targets, preds, classes):
    ps, rs, fs = [], [], []
    for c in classes:
        p, r, f = _prf_binary((targets == c).astype(int),
                              (preds == c).astype(int))
        ps.append(p)
        rs.append(r)
        fs.append(f)
    return float(np.mean(ps)), float(np.mean(rs)), float(np.mean(fs))


def binary_auc_from_scores(targets: np.ndarray, scores: np.ndarray) -> float:
    """ROC-AUC by the rank statistic, ties at their average rank (equals
    sklearn's roc_curve + auc); nan when a class is absent."""
    targets = np.asarray(targets).astype(int)
    scores = np.asarray(scores).astype(float)
    pos = scores[targets == 1]
    neg = scores[targets == 0]
    if len(pos) == 0 or len(neg) == 0:
        return float("nan")
    both = np.concatenate([neg, pos])
    order = np.argsort(both, kind="mergesort")
    _, inv, counts = np.unique(both[order], return_inverse=True,
                               return_counts=True)
    cum = np.cumsum(counts)
    avg_rank = (cum - (counts - 1) / 2.0).astype(float)
    ranks = np.empty(len(order), dtype=float)
    ranks[order] = avg_rank[inv]
    r_pos = ranks[len(neg):].sum()
    n_pos, n_neg = len(pos), len(neg)
    return float((r_pos - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def binary_auc_from_probs(targets: np.ndarray, probs: np.ndarray) -> float:
    """Binary AUC ranked by the positive class's probability column."""
    return binary_auc_from_scores(targets, probs[:, 1])


def multiclass_auc_ovr(targets: np.ndarray, probs: np.ndarray) -> float:
    """Macro one-vs-rest AUC over probability columns."""
    aucs = []
    for c in range(probs.shape[1]):
        t = (targets == c).astype(int)
        if t.min() == t.max():
            continue
        aucs.append(binary_auc_from_scores(t, probs[:, c]))
    return float(np.mean(aucs)) if aucs else float("nan")


def metrics(outputs: np.ndarray, targets: np.ndarray, average: str):
    """(precision, recall, f1, auc) of probabilities [N, C] against int
    targets; `average` is 'binary' or 'macro'."""
    outputs = np.asarray(outputs)
    targets = np.asarray(targets)
    preds = outputs.argmax(1)
    if average == "binary":
        precision, recall, f1 = _prf_binary(targets, preds)
        aucroc = binary_auc_from_scores(targets, preds.astype(float))
    else:
        classes = np.unique(np.concatenate([targets, preds]))
        precision, recall, f1 = _prf_macro(targets, preds, classes)
        aucroc = multiclass_auc_ovr(targets, outputs)
    return precision, recall, f1, aucroc
