"""Reliability / proximity diagnostics plotting.

Parity target: reference ``tools/plot.py`` — every public function
there has an equivalent here with the same outputs:

- ``plot_reliability_diagram`` (ref ``:8-72``): per-bin accuracy bars vs
  the identity line, gap hatched, ECE annotation; ``save_dir`` is a FILE
  path.
- ``plot_proximity_conf`` (ref ``:75-116``): index line plots of the
  proximity and confidence series; ``save_dir`` is a DIRECTORY (created),
  file name depends on ``sort_by_conf``. The reference sorts by
  *proximity* even when ``sort_by_conf=True`` (its ``:92`` quirk) —
  preserved.
- ``compute_ece`` (ref ``:122-138``): binary-style ECE over a 1-D prob
  array with rounded predictions.
- ``plot_proximity_acc_ece`` (ref ``:140-225``): sort by proximity, split
  into 10 equal-count bins, save a per-bin reliability diagram
  (``<i>_.png``) plus a 3-row accuracy/confidence/ECE summary figure
  (``proximity_acc_ece.png``) into the ``save_dir`` directory.
- ``reliability_diagram`` (ref ``:230-286``): figure-returning variant,
  default 10 bins, returns ``(fig, ece)``.

Matplotlib runs headless (Agg).
"""

from __future__ import annotations

import os

import numpy as np


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _binned_acc_conf(preds, confs, labels, n_bins):
    """Shared per-confidence-bin accuracy/means + histogram-weighted ECE
    (reference ``plot.py:11-35``, incl. the digitize-on-right-edge
    behavior for conf == 1.0)."""
    bins = np.linspace(0, 1, n_bins + 1)
    idx = np.digitize(confs, bins) - 1
    bin_acc = np.zeros(n_bins)
    bin_conf = np.zeros(n_bins)
    for i in range(n_bins):
        in_bin = idx == i
        if in_bin.any():
            bin_acc[i] = np.mean(labels[in_bin] == preds[in_bin])
            bin_conf[i] = np.mean(confs[in_bin])
    weights = np.histogram(confs, bins)[0] / len(confs)
    ece = np.sum(weights * np.abs(bin_conf - bin_acc))
    return bin_acc, bin_conf, ece


def _draw_reliability(ax, bin_acc, ece, n_bins, title):
    delta = 1.0 / n_bins
    x = np.arange(0, 1, delta)
    mid = np.linspace(delta / 2, 1 - delta / 2, n_bins)
    gap = np.abs(mid - bin_acc)
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.grid(color="tab:grey", linestyle=(0, (1, 5)), linewidth=1, zorder=0)
    ax.bar(x, bin_acc, color="b", width=delta, align="edge",
           edgecolor="k", label="Outputs", zorder=5)
    ax.bar(x, gap, bottom=np.minimum(bin_acc, mid), color="mistyrose",
           alpha=0.5, width=delta, align="edge", edgecolor="r", hatch="/",
           label="Gap", zorder=10)
    ax.plot([0, 1], [0, 1], linestyle="--", color="tab:grey", zorder=15)
    ax.set_ylabel("Accuracy", fontsize=13)
    ax.set_xlabel("Confidence", fontsize=13)
    ax.legend(loc="upper left", framealpha=1.0, fontsize="medium")
    ax.text(0.025, 0.85, f"ECE: {ece * 100:.2f}%", transform=ax.transAxes,
            bbox=dict(boxstyle="round, pad=0.5", facecolor="wheat",
                      edgecolor="orange"))
    if title is not None:
        ax.set_title(title, fontsize=16)


def plot_reliability_diagram(preds, confs, labels, n_bins: int = 15,
                             title=None, save_dir=None):
    """Reference ``plot.py:8-72``; ``save_dir`` is a file path. Returns
    the plotted ECE."""
    plt = _plt()
    preds = np.asarray(preds)
    confs = np.asarray(confs, np.float64)
    labels = np.asarray(labels)
    bin_acc, _, ece = _binned_acc_conf(preds, confs, labels, n_bins)
    fig, ax = plt.subplots(figsize=(6, 6))
    _draw_reliability(ax, bin_acc, ece, n_bins, title)
    fig.tight_layout()
    if save_dir is not None:
        fig.savefig(save_dir)
    plt.close(fig)
    return ece


def reliability_diagram(preds, confs, labels, n_bins: int = 10,
                        title=None):
    """Reference ``plot.py:230-286``: returns ``(fig, ece)`` without
    saving (the reference returns the pyplot module; callers only use
    ``.savefig``, which the figure provides)."""
    plt = _plt()
    preds = np.asarray(preds)
    confs = np.asarray(confs, np.float64)
    labels = np.asarray(labels)
    bin_acc, _, ece = _binned_acc_conf(preds, confs, labels, n_bins)
    fig, ax = plt.subplots(figsize=(6, 6))
    _draw_reliability(ax, bin_acc, ece, n_bins, title)
    fig.tight_layout()
    return fig, ece


def plot_proximity_conf(proximity, conf, save_dir, sort_by_conf=True):
    """Reference ``plot.py:75-116``: line plots of the two series over
    sample index; ``save_dir`` is a directory (created if missing)."""
    plt = _plt()
    proximity = np.asarray(proximity, np.float64)
    conf = np.asarray(conf, np.float64)
    if len(proximity) != len(conf):
        raise ValueError(
            "proximity and conf lists must have the same length!")
    if sort_by_conf:
        # reference quirk (:92): the "sorted by conf" branch actually
        # sorts by proximity
        order = np.argsort(proximity, kind="stable")
        proximity = proximity[order]
        conf = conf[order]
    os.makedirs(save_dir, exist_ok=True)

    fig, ax = plt.subplots(figsize=(10, 6))
    ax.plot(proximity, label="Proximity", color="blue")
    ax.plot(conf, label="Conf", color="red")
    ax.legend()
    ax.set_title("Proximity and Conf Plot (Sorted by Conf)"
                 if sort_by_conf else "Proximity and Conf Plot")
    ax.set_xlabel("Index")
    ax.set_ylabel("Value")
    filename = ("proximity_conf_plot_sorted.png" if sort_by_conf
                else "proximity_conf_plot.png")
    fig.savefig(os.path.join(save_dir, filename))
    plt.close(fig)


def compute_ece(probs, true_labels, num_bins: int = 10):
    """Reference ``plot.py:122-138``: ECE over a 1-D probability array
    with np.round as the prediction rule."""
    probs = np.asarray(probs, np.float64)
    true_labels = np.asarray(true_labels)
    edges = np.linspace(0, 1, num_bins + 1)
    ece = 0.0
    for lo, hi in zip(edges[:-1], edges[1:]):
        in_bin = np.logical_and(probs >= lo, probs < hi)
        prop = np.mean(in_bin)
        if prop > 0:
            acc = np.mean(true_labels[in_bin] == np.round(probs[in_bin]))
            ece += np.abs(acc - np.mean(probs[in_bin])) * prop
    return ece


def plot_proximity_acc_ece(proximity, pred, label, conf, save_dir):
    """Reference ``plot.py:140-225``: sort by proximity, 10 equal-count
    positional bins (last takes the remainder), save each bin's
    reliability diagram as ``<i>_.png`` and a 3-row summary as
    ``proximity_acc_ece.png`` under the ``save_dir`` directory."""
    plt = _plt()
    os.makedirs(save_dir, exist_ok=True)

    proximity = np.asarray(proximity, np.float64)
    pred = np.asarray(pred)
    label = np.asarray(label)
    conf = np.asarray(conf, np.float64)

    order = np.argsort(proximity, kind="stable")
    pred, label = pred[order], label[order]
    conf, proximity = conf[order], proximity[order]

    n = len(proximity)
    bin_size = n // 10
    accs, confs, eces, centers = [], [], [], []
    for i in range(10):
        lo = i * bin_size
        hi = (i + 1) * bin_size if i != 9 else n
        bp, bl = pred[lo:hi], label[lo:hi]
        bc, bx = conf[lo:hi], proximity[lo:hi]
        fig, ece = reliability_diagram(bp, bc, bl)
        fig.savefig(os.path.join(save_dir, f"{i}_.png"))
        plt.close(fig)
        accs.append(np.mean(bl == bp))
        confs.append(np.mean(bc))
        eces.append(ece)
        centers.append(np.mean(bx))

    fig, axs = plt.subplots(3, 1, figsize=(10, 15))
    panels = ((accs, "Accuracy", "Accuracy (%)", "o", "b",
               np.mean(accs)),
              (confs, "Confidence", "Confidence  (%)", "x", "r",
               np.mean(conf)),
              (eces, "ECE", "ECE (%)", "x", "g", np.mean(eces)))
    for ax, (ys, name, ylabel, marker, color, avg) in zip(axs, panels):
        ax.plot(centers, [y * 100 for y in ys], marker=marker,
                label=name, color=color)
        ax.set_xlabel("Average Proximity")
        ax.set_ylabel(ylabel)
        ax.set_title(name)
        ax.legend()
        ax.grid(True)
        ax.set_xticks(centers)
        ax.set_xticklabels([f"{c:.2f}" for c in centers])
        ax.text(0.05, 0.95, f"Avg: {avg * 100:.2f}%",
                transform=ax.transAxes, verticalalignment="top")
    fig.tight_layout()
    fig.savefig(os.path.join(save_dir, "proximity_acc_ece.png"))
    plt.close(fig)
