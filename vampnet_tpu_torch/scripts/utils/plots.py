"""Plots of eval metrics (counterpart of the repository's
`scripts/utils/plots.py`): mel-loss box plots and FAD bars per condition
from a `metrics-all.csv` read into a pandas DataFrame. matplotlib and
pandas are imported when a plot is made.
"""
from __future__ import annotations


def plot_metrics(metrics, condition_to_latex, title, color_palette):
    import matplotlib.pyplot as plt
    from pandas.api.types import CategoricalDtype

    metrics = metrics.copy()
    metrics["condition_latex"] = metrics["condition"].map(condition_to_latex)
    cat_type = CategoricalDtype(categories=list(condition_to_latex.values()), ordered=True)
    metrics["condition_latex"] = metrics["condition_latex"].astype(cat_type)

    grouped = metrics.groupby("condition_latex", observed=False)[["mel", "frechet"]].agg(
        ["mean", "std"])
    fig, axs = plt.subplots(2, 1, figsize=(7, 5.25))
    fig.suptitle(title, fontsize=16)
    bar_colors = [color_palette.get(c, "gray") for c in grouped.index]

    conds = list(grouped.index)
    data = [metrics.loc[metrics["condition_latex"] == c, "mel"] for c in conds]
    axs[0].boxplot(data, tick_labels=conds, showfliers=False)
    axs[0].set_ylabel("Mel Spectrogram Loss \u2190")

    axs[1].bar(grouped.index, grouped["frechet"]["mean"], yerr=grouped["frechet"]["std"],
               color=bar_colors)
    axs[1].set_ylabel("FAD \u2190")
    plt.tight_layout(rect=[0, 0, 1, 0.96])
    return fig
