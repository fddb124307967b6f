"""Streaming confusion matrix (counterpart of
`dpcr_agb_tpu/metrics/confusion_matrix.py`): numpy accumulators, for the
classification targets (`y_cls`) of the data layer, which the NFI
regression pipeline does not use. `save_confusion_matrix` draws with
matplotlib, imported when it is called; without it, it raises naming it."""
from __future__ import annotations

import os
from typing import Sequence, Union

import numpy as np

_EPS = float(np.finfo(np.float32).eps)


class ConfusionMatrix:
    """Count (ground_truth, predicted) pairs one batch at a time, then read
    accuracy / macro-accuracy / precision / recall / F1 / IoU."""

    def __init__(self, cls_names: Union[int, Sequence]):
        if isinstance(cls_names, (int, np.integer)):
            cls_names = [str(i) for i in range(int(cls_names))]
        self.cls_names = np.asarray(cls_names)
        self.n_cls = len(self.cls_names)
        self.confusion_matrix = None

    @staticmethod
    def create_from_matrix(confusion_matrix: np.ndarray) -> "ConfusionMatrix":
        confusion_matrix = np.asarray(confusion_matrix)
        if confusion_matrix.shape[0] != confusion_matrix.shape[1]:
            raise ValueError(f"not square: {confusion_matrix.shape}")
        matrix = ConfusionMatrix(confusion_matrix.shape[0])
        matrix.confusion_matrix = confusion_matrix
        return matrix

    def count_predicted_batch(self, ground_truth_vec, predicted) -> None:
        gt = np.asarray(ground_truth_vec).astype(np.int64).ravel()
        pr = np.asarray(predicted).astype(np.int64).ravel()
        if pr.max(initial=0) >= self.n_cls:
            raise ValueError(f"predicted class {pr.max()} >= {self.n_cls}")
        batch = np.bincount(self.n_cls * gt + pr,
                            minlength=self.n_cls ** 2
                            ).reshape(self.n_cls, self.n_cls)
        if self.confusion_matrix is None:
            self.confusion_matrix = batch
        else:
            self.confusion_matrix = self.confusion_matrix + batch

    def get_count(self, ground_truth: int, predicted: int) -> int:
        return int(self.confusion_matrix[ground_truth][predicted])

    def get_confusion_matrix(self) -> np.ndarray:
        return self.confusion_matrix

    def get_intersection_union_per_class(self):
        cmat = self.confusion_matrix.astype(np.float64)
        tp = np.diag(cmat)
        union = cmat.sum(0) + cmat.sum(1) - tp
        present = union > 0
        iou = tp / np.maximum(union, _EPS)
        return iou, present

    def get_average_intersection_union(self, missing_as_one: bool = False):
        iou, present = self.get_intersection_union_per_class()
        if missing_as_one:
            iou = np.where(present, iou, 1.0)
            present = np.ones_like(present)
        if present.sum() == 0:
            return 0.0
        return float(iou[present].mean())

    def get_overall_accuracy(self) -> float:
        cmat = self.confusion_matrix.astype(np.float64)
        total = cmat.sum()
        if total == 0:
            return 0.0
        return float(np.diag(cmat).sum() / total)

    def get_mean_class_accuracy(self) -> float:
        cmat = self.confusion_matrix.astype(np.float64)
        numel = cmat.sum(1)
        mask = numel > 0
        if mask.sum() == 0:
            return 0.0
        return float((np.diag(cmat)[mask] / numel[mask]).mean())

    def get_stats(self):
        """(stats, class_stats, cmat): tp/fp/acc/macc/precision/recall/f1
        and per-class entries (empty dicts when no class has a sample)."""
        cmat = self.confusion_matrix.astype(np.float64)
        stats: dict = {}
        class_stats: dict = {}
        numel = cmat.sum(1)
        mask = numel > 0
        if mask.sum() == 0:
            return stats, class_stats, cmat
        tp = np.diag(cmat)[mask]
        stats["tp"] = float(tp.sum())
        fp = cmat.sum(0)[mask] - tp
        stats["fp"] = float(fp.sum())
        fn = cmat.sum(1)[mask] - tp
        stats["acc"] = float(tp.sum() / numel.sum())
        acc = tp / numel[mask]
        stats["macc"] = float(acc.mean())
        precision = tp / (tp + fp + _EPS)
        stats["precision"] = float(precision.mean())
        recall = tp / (tp + fn + _EPS)
        stats["recall"] = float(recall.mean())
        f1 = 2 * ((precision * recall) / (precision + recall + _EPS))
        stats["f1"] = float(f1.mean())
        for i, cls_name in enumerate(self.cls_names[mask]):
            class_stats["acc", cls_name] = float(acc[i])
            class_stats["tp", cls_name] = float(tp[i])
            class_stats["recall", cls_name] = float(recall[i])
            class_stats["precision", cls_name] = float(precision[i])
            class_stats["f1", cls_name] = float(f1[i])
        return stats, class_stats, cmat


def save_confusion_matrix(cm: np.ndarray, path2save: str,
                          ordered_names: Sequence[str]) -> None:
    """Write precision.svg and recall.svg heatmaps into path2save (the
    matrix normalised by rows and by columns) with matplotlib."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("save_confusion_matrix draws with matplotlib, "
                          "which is not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    cm = np.asarray(cm, dtype=np.float64)
    names = list(ordered_names)

    def heat(cmn: np.ndarray, path: str) -> None:
        cmn = cmn.copy()
        cmn[~np.isfinite(cmn)] = 0
        n = len(names)
        fig, ax = plt.subplots(figsize=(max(6, 0.6 * n), max(5, 0.55 * n)))
        im = ax.imshow(cmn, cmap="viridis", vmin=0.0, vmax=1.0)
        ax.set_xticks(range(n), names, rotation=35, ha="right")
        ax.set_yticks(range(n), names)
        for i in range(n):
            for j in range(n):
                ax.text(j, i, f"{cmn[i, j]:.2f}", ha="center", va="center",
                        color="white" if cmn[i, j] < 0.5 else "black",
                        fontsize=8)
        ax.set_ylabel("Actual")
        ax.set_xlabel("Predicted")
        fig.colorbar(im, ax=ax)
        fig.tight_layout()
        fig.savefig(path, format="svg")
        plt.close(fig)

    row_sum = cm.sum(axis=-1, keepdims=True)
    heat(cm / np.where(row_sum == 0, 1, row_sum),
         os.path.join(path2save, "precision.svg"))
    col_sum = cm.sum(axis=0, keepdims=True)
    heat(cm / np.where(col_sum == 0, 1, col_sum),
         os.path.join(path2save, "recall.svg"))
