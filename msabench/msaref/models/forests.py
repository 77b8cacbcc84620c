# Frozen copy of mlprobs_tpu_torch/models/forests.py at commit 30598a0 (the
# benchmark's plain reference: PyTorch and NumPy only, no CUDA kernel
# and no C++ helper; see msabench/msaref/__init__.py).
"""Random-forest classifiers re-expressed as flat array traversal.

The reference ships three sklearn-0.21 RandomForestClassifier pickles
(classifier/model/{branch,regions,seq_lens}/randomforest.joblib) driving
strategy decisions (utils/classifier_*.py).  We re-serialise their node
arrays (tools/extract_assets.py) and evaluate them directly: soft voting —
average the per-tree class-probability vectors, then argmax — exactly
sklearn's `RandomForestClassifier.predict`.

Inputs are min-max normalised with the shipped para.txt constants:
(v - min) / (max - min), cf. classifier_realign_strategy.py:22-26.
"""
from __future__ import annotations

import functools
from pathlib import Path

import numpy as np

_ASSETS = Path(__file__).resolve().parent / "assets"


class Forest:
    def __init__(self, data: dict[str, np.ndarray], tier: str):
        self.feature = data[f"{tier}_feature"]
        self.threshold = data[f"{tier}_threshold"]
        self.left = data[f"{tier}_left"]
        self.right = data[f"{tier}_right"]
        self.value = data[f"{tier}_value"]
        self.offsets = data[f"{tier}_offsets"]
        self.classes = data[f"{tier}_classes"]
        self.norm = None  # (F, 2) rows of (max, min)

    def normalise(self, features: np.ndarray) -> np.ndarray:
        mx, mn = self.norm[:, 0], self.norm[:, 1]
        return (np.asarray(features, dtype=np.float64) - mn) / (mx - mn)

    def predict_normalised(self, feats: np.ndarray) -> int:
        """Predict a class from already-normalised features."""
        proba = np.zeros(len(self.classes))
        for t in range(len(self.offsets) - 1):
            node = self.offsets[t]
            while self.left[node] != -1:
                if feats[self.feature[node]] <= self.threshold[node]:
                    node = self.offsets[t] + self.left[node]
                else:
                    node = self.offsets[t] + self.right[node]
            counts = self.value[node]
            proba += counts / counts.sum()
        return int(self.classes[np.argmax(proba)])

    def predict(self, features) -> int:
        return self.predict_normalised(self.normalise(features))


@functools.lru_cache(maxsize=1)
def _load() -> dict[str, Forest]:
    with np.load(_ASSETS / "forests.npz") as z:
        data = {k: z[k] for k in z.files}
    with np.load(_ASSETS / "params.npz") as z:
        norms = {k: z[k] for k in z.files if k.startswith("norm_")}
    out = {}
    for tier in ["branch", "regions", "seq_lens"]:
        f = Forest(data, tier)
        f.norm = norms[f"norm_{tier}"]
        out[tier] = f
    return out


def classify_strategy(avg_pid, num_seqs, avg_len, avg_sp, peak_ratio) -> int:
    """Classifier 1: 0 = progressive, 1 = non-progressive.

    Feature order matches prepare_features_4_classifier_1.py:27-34;
    out-of-range predictions collapse to 0 (classifier_c_p_np_aln.py:24-25).
    """
    c = _load()["branch"].predict(
        [avg_pid, num_seqs, avg_len, avg_sp, peak_ratio]
    )
    return 0 if (c >= 2 or c < 0) else c


def classify_realign_strategy(peak_ratio, avg_pid, sd_un_sp, un_sp) -> int:
    """Classifier 3: 0 = realign credible (RCR), 1 = realign incredible (RIR).

    Out-of-range -> 1 (classifier_realign_strategy.py:28-29).
    """
    c = _load()["regions"].predict([peak_ratio, avg_pid, sd_un_sp, un_sp])
    return 1 if (c > 1 or c < 0) else c


def classify_region_min_length(
    align_len, num_seqs, avg_pid, sd_pid, un_sp
) -> int:
    """Classifier 2: region min-length class 0-3.

    Out-of-range -> 3 (classifier_region_min_length.py:28-29).
    """
    c = _load()["seq_lens"].predict(
        [align_len, num_seqs, avg_pid, sd_pid, un_sp]
    )
    return 3 if (c > 3 or c < 0) else c
