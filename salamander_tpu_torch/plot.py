"""Plotting (`sal.pl`): signature barplots, stacked exposures, embeddings,
correlation clustermaps, objective history, rank selection, ARD relevance,
bootstrap exposure intervals and catalog decompositions.

Copied from salamander_tpu/plot.py (host matplotlib, seaborn and scipy;
nothing here touches a tensor). matplotlib and seaborn are optional for the
package: the facade imports this module under an ImportError guard and the
models' plot_* methods import it when called. Optional extras degrade
gracefully: adjustText (annotation de-overlap) and fastcluster (fast
linkage) are used when present, otherwise skipped/replaced by scipy.
"""

from __future__ import annotations

from typing import Any, Iterable

import matplotlib as mpl
import matplotlib.pyplot as plt
import numpy as np
import pandas as pd
import seaborn as sns
from matplotlib.axes import Axes
from scipy.cluster import hierarchy
from scipy.spatial.distance import pdist

from .consts import (
    CN_TYPES_48,
    COLORS_CN48,
    COLORS_DBS78,
    COLORS_INDEL83,
    COLORS_SBS96,
    COLORS_SV32,
    DBS_TYPES_78,
    INDEL_TYPES_83,
    SBS_TYPES_96,
    SV_TYPES_32,
)
from .utils import _concat_light, _get_basis_obsm, _get_basis_obsp, match_to_catalog


def set_salamander_style() -> None:
    """Apply the package-wide matplotlib/seaborn style."""
    sns.set_context("notebook")
    sns.set_style("ticks")
    mpl.rcParams.update(
        {
            "axes.edgecolor": "black",
            "axes.labelsize": "medium",
            "axes.spines.top": False,
            "axes.spines.right": False,
            "axes.titlesize": "large",
            "font.family": "DejaVu Sans",
            "legend.fontsize": "medium",
            "pdf.fonttype": 42,
            "xtick.labelsize": "small",
            "ytick.labelsize": "small",
        }
    )


def history(
    values,
    conv_test_freq: int,
    min_iteration: int = 0,
    ax: Axes | None = None,
    **kwargs,
) -> Axes:
    """Objective value vs iteration number (x grid = conv_test_freq)."""
    values = np.asarray(values)
    iterations = np.arange(1, len(values) + 1) * conv_test_freq
    if min_iteration > iterations[-1]:
        raise ValueError(
            "The smallest iteration number shown in the history plot "
            "cannot be larger than the total number of iterations."
        )
    if ax is None:
        _, ax = plt.subplots(figsize=(4, 4))
    ax.set(xlabel="n_iteration", ylabel="objective function value")
    first = int(np.argmax(iterations >= min_iteration))
    ax.plot(iterations[first:], values[first:], **kwargs)
    return ax


# --------------------------------------------------------------------------
# scatter / embedding family
# --------------------------------------------------------------------------

def _annotate_plot(
    ax: Axes,
    data: np.ndarray,
    annotations: Iterable[str],
    fontsize="small",
    color="black",
    adjust_annotations: bool = True,
    adjust_kwargs: dict[str, Any] | None = None,
    **kwargs,
) -> None:
    for point, annotation in zip(data, annotations):
        ax.text(point[0], point[1], annotation, fontsize=fontsize,
                color=color, **kwargs)
    if adjust_annotations:
        try:
            from adjustText import adjust_text
        except ImportError:
            return
        adjust_kwargs = {} if adjust_kwargs is None else adjust_kwargs.copy()
        texts = [
            child for child in ax.get_children()
            if isinstance(child, mpl.text.Text) and child.get_text()
        ]
        adjust_text(texts, **adjust_kwargs)


def _scatter_groups(ax: Axes, xs, ys, color, zorder, **kwargs) -> None:
    """Scatter points grouped by zorder so draw order is controllable."""
    zorder = np.asarray(zorder)
    for z in np.unique(zorder):
        idx = np.where(zorder == z)[0]
        group_color = [color[i] for i in idx] if color is not None else None
        sns.scatterplot(
            x=xs[idx], y=ys[idx], color=group_color, zorder=int(z), ax=ax,
            **kwargs,
        )


def _scatter_1d(data, xlabel=None, color=None, zorder=None, ax=None, **kwargs):
    data = np.asarray(data).flatten()
    if ax is None:
        _, ax = plt.subplots(figsize=(4, 1))
    if zorder is None:
        zorder = len(data) * [1]
    ax.spines[["left", "bottom"]].set_visible(False)
    ax.get_yaxis().set_visible(False)
    ax.axhline(y=0, color="black", zorder=int(np.min(zorder)) - 1)
    _scatter_groups(ax, data, np.zeros_like(data), color, zorder, **kwargs)
    if xlabel:
        ax.set_xlabel(xlabel)
    return ax


def _scatter_2d(data, xlabel=None, ylabel=None, ticks=True, color=None,
                zorder=None, ax=None, **kwargs):
    data = np.asarray(data)
    if data.shape[1] != 2:
        raise ValueError("The datapoints (rows) have to be two-dimensional.")
    if ax is None:
        _, ax = plt.subplots(figsize=(4, 4))
    if zorder is None:
        zorder = len(data) * [1]
    _scatter_groups(ax, data[:, 0], data[:, 1], color, zorder, **kwargs)
    if xlabel:
        ax.set_xlabel(xlabel)
    if ylabel:
        ax.set_ylabel(ylabel)
    if not ticks:
        ax.set(xticks=[], yticks=[])
    return ax


def scatter_numpy(
    data: np.ndarray,
    xlabel=None,
    ylabel=None,
    ticks: bool = True,
    color=None,
    zorder=None,
    annotations=None,
    annotation_kwargs=None,
    adjust_annotations: bool = True,
    adjust_kwargs=None,
    ax: Axes | None = None,
    **kwargs,
) -> Axes:
    data = np.asarray(data)
    if data.ndim == 1 or data.shape[1] == 1:
        ax = _scatter_1d(data, xlabel, color, zorder, ax, **kwargs)
        flat = data.flatten()
        data_2d = np.vstack([flat, np.zeros_like(flat)]).T
    elif data.ndim == 2 and data.shape[1] == 2:
        ax = _scatter_2d(data, xlabel, ylabel, ticks, color, zorder, ax, **kwargs)
        data_2d = data
    else:
        raise ValueError(
            "Scatterplots are only supported for one- or two-dimensional data."
        )
    if annotations is not None:
        annotation_kwargs = (
            {} if annotation_kwargs is None else annotation_kwargs.copy()
        )
        _annotate_plot(
            ax, data_2d, annotations,
            adjust_annotations=adjust_annotations,
            adjust_kwargs=adjust_kwargs,
            **annotation_kwargs,
        )
    return ax


def scatter(adata, x: str, y: str | None = None, ticks: bool = True,
            color: str | None = None, zorder: str | None = None, **kwargs):
    if y is None:
        data = np.asarray(adata.obs[x])
    else:
        data = adata.obs[[x, y]].to_numpy()
    col = list(adata.obs[color]) if color is not None else None
    zord = list(adata.obs[zorder]) if zorder is not None else None
    return scatter_numpy(
        data, xlabel=x, ylabel=y, ticks=ticks, color=col, zorder=zord, **kwargs
    )


def scatter_multiple(adatas, x: str, y: str | None = None, ticks: bool = True,
                     color: str | None = None, zorder: str | None = None,
                     **kwargs):
    obs_keys = [key for key in (x, y, color, zorder) if key is not None]
    combined = _concat_light(adatas, obs_keys=obs_keys)
    return scatter(combined, x=x, y=y, ticks=ticks, color=color,
                   zorder=zorder, **kwargs)


def embedding_numpy(data, dimensions=(0, 1), xlabel=None, ylabel=None,
                    ticks=True, color=None, zorder=None, **kwargs):
    data = np.asarray(data)
    if data.ndim == 2 and data.shape[1] > 2:
        data = data[:, list(dimensions)]
    return scatter_numpy(data, xlabel, ylabel, ticks, color, zorder, **kwargs)


_BASIS_LABELS = {"pca": "PC", "tsne": "tSNE", "umap": "UMAP"}


def embedding(adata, basis: str, dimensions=(0, 1), xlabel=None, ylabel=None,
              ticks: bool | None = None, color: str | None = None,
              zorder: str | None = None, **kwargs):
    data = _get_basis_obsm(adata, basis)
    name = _BASIS_LABELS.get(basis, basis)
    if xlabel is None:
        xlabel = f"{name}{dimensions[0] + 1}"
    if ylabel is None:
        ylabel = f"{name}{dimensions[1] + 1}"
    if ticks is None:
        ticks = basis not in ("tsne", "umap")
    col = list(adata.obs[color]) if color is not None else None
    zord = list(adata.obs[zorder]) if zorder is not None else None
    return embedding_numpy(
        data, dimensions=dimensions, xlabel=xlabel, ylabel=ylabel,
        ticks=ticks, color=col, zorder=zord, **kwargs,
    )


def embedding_multiple(adatas, basis: str, dimensions=(0, 1), xlabel=None,
                       ylabel=None, ticks=None, color=None, zorder=None,
                       **kwargs):
    obs_keys = [key for key in (color, zorder) if key is not None]
    combined = _concat_light(adatas, obs_keys=obs_keys, obsm_keys=[basis])
    return embedding(
        combined, basis=basis, dimensions=dimensions, xlabel=xlabel,
        ylabel=ylabel, ticks=ticks, color=color, zorder=zorder, **kwargs,
    )


def pca(adata, **kwargs):
    return embedding(adata, basis="pca", **kwargs)


def pca_multiple(adatas, **kwargs):
    return embedding_multiple(adatas, basis="pca", **kwargs)


def tsne(adata, **kwargs):
    return embedding(adata, basis="tsne", **kwargs)


def tsne_multiple(adatas, **kwargs):
    return embedding_multiple(adatas, basis="tsne", **kwargs)


def umap(adata, **kwargs):
    return embedding(adata, basis="umap", **kwargs)


def umap_multiple(adatas, **kwargs):
    return embedding_multiple(adatas, basis="umap", **kwargs)


# --------------------------------------------------------------------------
# correlation
# --------------------------------------------------------------------------

def correlation_pandas(corr: pd.DataFrame, figsize=(4.0, 4.0), cmap="vlag",
                       fmt: str = ".2f", **kwargs):
    linkage = hierarchy.linkage(corr)
    return sns.clustermap(
        corr, row_linkage=linkage, figsize=figsize, vmin=-1, vmax=1,
        cmap=cmap, fmt=fmt, **kwargs,
    )


def correlation(adata, **kwargs):
    corr = pd.DataFrame(
        _get_basis_obsp(adata, "correlation"),
        index=adata.obs_names,
        columns=adata.obs_names,
    )
    return correlation_pandas(corr, **kwargs)


# --------------------------------------------------------------------------
# barplot family
# --------------------------------------------------------------------------

def _get_colors_barplot(var_names, colors=None):
    """Resolve the bar colors: SBS96/Indel83/DBS78/CN48/SV32 standards
    auto-detected from the feature set, single colors broadcast, explicit
    lists validated.

    SBS96/Indel83 detection matches the reference (plot.py:420-457); DBS78
    (COSMIC doublet-base substitutions), CN48 (copy-number segments) and
    SV32 (structural variants) are beyond-reference."""
    var_names = list(var_names)
    n_vars = len(var_names)

    for tag, noun, vocab, palette in (
        ("CN48", "CN", CN_TYPES_48, COLORS_CN48),
        ("SV32", "SV", SV_TYPES_32, COLORS_SV32),
    ):
        if colors == tag or (
            n_vars == len(vocab) and var_names == vocab and colors is None
        ):
            if n_vars != len(vocab):
                raise ValueError(
                    f"The standard {noun} colors can only be used when the "
                    f"signatures have {len(vocab)} features."
                )
            return palette
    if colors == "SBS96" or (
        n_vars == 96 and var_names == SBS_TYPES_96 and colors is None
    ):
        if n_vars != 96:
            raise ValueError(
                "The standard SBS colors can only be used "
                "when the signatures have 96 features."
            )
        return COLORS_SBS96
    if colors == "Indel83" or (
        n_vars == 83 and var_names == INDEL_TYPES_83 and colors is None
    ):
        if n_vars != 83:
            raise ValueError(
                "The standard Indel colors can only be used "
                "when the signatures have 83 features."
            )
        return COLORS_INDEL83
    if colors == "DBS78" or (
        n_vars == 78 and var_names == DBS_TYPES_78 and colors is None
    ):
        if n_vars != 78:
            raise ValueError(
                "The standard DBS colors can only be used "
                "when the signatures have 78 features."
            )
        return COLORS_DBS78
    if type(colors) in (str, tuple):
        return n_vars * [colors]
    if type(colors) is list:
        if len(colors) != n_vars:
            raise ValueError(
                f"The list of colors must be of length n_vars={n_vars}."
            )
        return colors
    return n_vars * ["gray"]


def _barplot_single(data: pd.DataFrame, colors=None, annotate_vars=False,
                    ax: Axes | None = None, **kwargs) -> Axes:
    """Relative values of a one-row dataframe (a single signature)."""
    if ax is None:
        _, ax = plt.subplots(figsize=(4, 1))
    normalized = data.div(data.sum(axis=1), axis=0)
    var_names = data.columns
    colors = _get_colors_barplot(var_names, colors)

    ax.set_title(data.index[0])
    ax.spines["left"].set_visible(False)
    ax.get_yaxis().set_visible(False)
    ax.set_xlim((-1, len(var_names)))
    ax.bar(var_names, normalized.iloc[0, :], linewidth=0, color=colors, **kwargs)

    if annotate_vars:
        ax.set_xticks(var_names)
        ax.set_xticklabels(
            var_names, family="monospace", fontsize="x-small",
            ha="center", rotation=90,
        )
    else:
        ax.set_xticks([])
    return ax


def _barplot_matched(data: pd.DataFrame, catalog: pd.DataFrame | None = None,
                     colors=None, annotate_vars=False, ax=None, **kwargs):
    """One signature, optionally side-by-side with its best catalog match."""
    if catalog is None:
        assert isinstance(ax, Axes) or ax is None
        return _barplot_single(
            data, colors=colors, annotate_vars=annotate_vars, ax=ax, **kwargs
        )
    if ax is None:
        _, axes = plt.subplots(1, 2, figsize=(8, 1))
    else:
        axes = ax
    matched = match_to_catalog(data, catalog, metric="cosine")
    for frame, axis in zip([data, matched], axes):
        _barplot_single(
            frame, colors=colors, annotate_vars=annotate_vars, ax=axis, **kwargs
        )
    return axes


def barplot_pandas(data: pd.DataFrame, catalog: pd.DataFrame | None = None,
                   colors=None, annotate_vars=False, axes=None, **kwargs):
    """Relative values of every row (signature grid), optionally with best
    catalog matches side by side."""
    n_obs = data.shape[0]
    if n_obs == 1:
        return _barplot_matched(
            data, catalog=catalog, colors=colors,
            annotate_vars=annotate_vars, ax=axes, **kwargs,
        )
    if axes is None:
        if catalog is None:
            _, axes = plt.subplots(n_obs, 1, figsize=(4, n_obs))
        else:
            _, axes = plt.subplots(n_obs, 2, figsize=(8, n_obs))
    assert isinstance(
        axes, np.ndarray
    ), "Adding multiple barplots to custom 'axes' requires 'axes' to be iterable."
    if catalog is None:
        axes = axes.flatten()
    for ax, row_name in zip(axes, data.index):
        _barplot_matched(
            data.loc[[row_name], :], catalog=catalog, colors=colors,
            annotate_vars=annotate_vars, ax=ax, **kwargs,
        )
    plt.tight_layout()
    return axes


def barplot(adata, **kwargs):
    return barplot_pandas(adata.to_df(), **kwargs)


# --------------------------------------------------------------------------
# stacked exposures
# --------------------------------------------------------------------------

def _linkage(distances):
    try:
        import fastcluster

        return fastcluster.linkage(distances)
    except ImportError:
        return hierarchy.linkage(distances)


def get_obs_order(data: pd.DataFrame, normalize: bool = True) -> np.ndarray:
    """Observation order for a stacked barplot: hierarchical clustering with
    optimal leaf ordering."""
    if normalize:
        data = data.div(data.sum(axis=1), axis=0)
    distances = pdist(data)
    linkage = _linkage(distances)
    leaves = hierarchy.leaves_list(
        hierarchy.optimal_leaf_ordering(linkage, distances)
    )
    return data.index[leaves].to_numpy()


def _reorder_data(data: pd.DataFrame, obs_order=None, normalize: bool = True,
                  reorder_dimensions: bool = True) -> pd.DataFrame:
    """Reorder observations (clustering) and optionally order the columns by
    decreasing total relative contribution."""
    if obs_order is None:
        obs_order = get_obs_order(data, normalize=normalize)
    reordered = data.loc[obs_order, :]
    if reorder_dimensions:
        normalized = data.div(data.sum(axis=1), axis=0)
        column_order = normalized.sum(axis=0).sort_values(ascending=False).index
        reordered = reordered[column_order]
    return reordered


def stacked_barplot(
    data: pd.DataFrame,
    obs_order=None,
    reorder_dimensions: bool = True,
    annotate_obs: bool = True,
    colors=None,
    title: str | None = None,
    ncol_legend: int = 1,
    ax: Axes | None = None,
    **kwargs,
) -> Axes:
    """Row-normalized stacked bar chart (typically signature exposures)."""
    n_obs, n_dimensions = data.shape
    data = data.div(data.sum(axis=1), axis=0)
    data = _reorder_data(
        data, obs_order=obs_order, reorder_dimensions=reorder_dimensions
    )
    if ax is None:
        _, ax = plt.subplots(figsize=(0.3 * n_obs, 4))
    if colors is None:
        colors = sns.color_palette("deep") * (1 + n_dimensions // 10)

    bottom = np.zeros(n_obs)
    for dimension, color in zip(data.columns, colors):
        values = data[dimension].to_numpy()
        ax.bar(
            np.arange(n_obs), values, color=color, width=1, label=dimension,
            linewidth=0, bottom=bottom, **kwargs,
        )
        bottom += values

    if annotate_obs:
        ax.set_xticks(np.arange(n_obs))
        ax.set_xticklabels(data.index, rotation=90, ha="center",
                           fontsize="x-small")
    else:
        ax.get_xaxis().set_visible(False)
    if title:
        ax.set_title(title)
    ax.spines[["left", "bottom"]].set_visible(False)
    ax.get_yaxis().set_visible(False)
    ax.legend(loc="center left", bbox_to_anchor=(0.975, 0.5), ncol=ncol_legend)
    return ax


# --------------------------------------------------------------------------
# rank selection (companion to tl.rank_selection_table; beyond-reference)
# --------------------------------------------------------------------------

def rank_selection(table, min_stability: float | None = 0.9, ax=None,
                   **kwargs) -> "Axes":
    """Plot a rank-selection table (tl.rank_selection_table output):
    best loss on the left axis, per-rank min/mean signature stability on
    the right (0..1, with the suggestion threshold as a dashed rule).
    The standard read: pick the largest rank whose stability stays above
    the rule before the loss elbow flattens."""
    if isinstance(table.index, pd.MultiIndex):
        raise ValueError(
            "plot one embedding dimension at a time: "
            "pl.rank_selection(table.xs(m, level='dim_embeddings'))"
        )
    if ax is None:
        _, ax = plt.subplots(figsize=(5, 4))
    ranks = np.asarray(table.index)
    ax.plot(ranks, table["best_loss"], marker="o", color="black",
            label="best loss", **kwargs)
    ax.set(xlabel="n_signatures", ylabel="best loss")
    ax.set_xticks(ranks)
    ax2 = ax.twinx()
    ax2.plot(ranks, table["mean_stability"], marker="s", color="tab:blue",
             label="mean stability")
    ax2.plot(ranks, table["min_stability"], marker="^", color="tab:red",
             label="min stability")
    if min_stability is not None:
        ax2.axhline(min_stability, color="tab:red", linestyle="--",
                    linewidth=1, alpha=0.6)
    ax2.set_ylabel("signature stability")
    ax2.set_ylim(min(0.5, float(table["min_stability"].min()) - 0.05), 1.02)
    handles1, labels1 = ax.get_legend_handles_labels()
    handles2, labels2 = ax2.get_legend_handles_labels()
    ax.legend(handles1 + handles2, labels1 + labels2, loc="center right",
              fontsize=8)
    return ax


def relevance(model_or_series, active_tol: float = 1e-2, ax=None,
              **kwargs) -> "Axes":
    """ARD relevance spectrum: per-signature relevance excess (log scale,
    sorted descending) with the active/pruned threshold as a dashed rule.

    Accepts a fitted ARDNMF model (uses `.relevance` and marks the
    `active_tol`-relative threshold) or any pd.Series of relevance values.
    The standard read: data-supported signatures sit orders of magnitude
    above the pruned floor; the count left of the rule is the inferred
    rank (model.n_active_signatures).
    """
    if hasattr(model_or_series, "relevance"):
        values = model_or_series.relevance
    else:
        values = pd.Series(model_or_series)
    values = values.sort_values(ascending=False)
    if ax is None:
        _, ax = plt.subplots(figsize=(5, 3.5))
    positions = np.arange(len(values))
    ax.bar(positions, np.maximum(values.to_numpy(), 1e-300), **kwargs)
    ax.set_yscale("log")
    ax.set_xticks(positions)
    ax.set_xticklabels(values.index, rotation=90, fontsize=8)
    ax.set(ylabel="relevance excess (f(w)+f(h))/b")
    threshold = active_tol * float(values.iloc[0])
    ax.axhline(threshold, color="tab:red", linestyle="--", linewidth=1,
               alpha=0.6, label=f"active threshold ({active_tol:g} x max)")
    ax.legend(fontsize=8)
    return ax


def exposure_uncertainty(boot, sample, top: int = 12, ax=None,
                         **kwargs) -> "Axes":
    """Bootstrap exposure CIs for ONE sample (assign.bootstrap_exposures
    output): horizontal bars of the point-estimate exposure fractions for
    the `top` signatures by point mass, with the bootstrap quantile range
    as error bars and each bar annotated by its presence probability.

    The standard read: a signature whose interval hugs zero or whose
    presence is well below 1 is not reliably distinguishable from
    reassignment noise, however nonzero its point exposure looks.
    """
    point = boot.point.loc[sample]
    total = max(float(point.sum()), 1e-300)
    qs = sorted(boot.quantiles)
    lo_q, hi_q = boot.quantiles[qs[0]], boot.quantiles[qs[-1]]
    names = list(point.nlargest(top).index)

    fractions = point[names].to_numpy() / total
    lo = lo_q.loc[sample, names].to_numpy() / total
    hi = hi_q.loc[sample, names].to_numpy() / total
    presence = boot.presence.loc[sample, names].to_numpy()

    if ax is None:
        _, ax = plt.subplots(figsize=(5, 0.35 * len(names) + 1.2))
    positions = np.arange(len(names))[::-1]
    err = np.stack([
        np.maximum(fractions - lo, 0.0), np.maximum(hi - fractions, 0.0)
    ])
    ax.barh(positions, fractions, xerr=err, capsize=2.5,
            color="tab:blue", alpha=0.85, **kwargs)
    for pos, frac, hi_v, prob in zip(positions, fractions, hi, presence):
        ax.text(max(hi_v, frac) + 0.01, pos, f"P={prob:.2f}",
                va="center", fontsize=7)
    ax.set_yticks(positions)
    ax.set_yticklabels(names, fontsize=8)
    ax.set_xlabel("exposure fraction")
    ax.set_title(
        f"{sample}: bootstrap {qs[0]:g}-{qs[-1]:g} quantiles", fontsize=9
    )
    ax.set_xlim(0, min(1.05, float(np.max(hi)) + 0.12))
    return ax


def decomposition(decomp, ax=None, cmap: str = "tab20",
                  min_label: float = 0.05) -> "Axes":
    """Catalog decomposition of de novo signatures
    (tl.decompose_signatures output): one horizontal stacked bar per
    signature, segments = its catalog mixture weights (rows sum to 1),
    segments >= `min_label` annotated with the catalog entry's name, and
    each bar suffixed by its reconstruction cosine.

    The standard read: a signature that is one long segment IS a known
    catalog entry; several major segments = a composite the model could
    not (or need not) split; a low cosine marks a genuinely novel
    signature whatever the mixture claims.
    """
    weights = decomp.weights
    names = list(weights.index)
    components = [
        column for column in weights.columns
        if (weights[column] > 0).any()
    ]
    colors = plt.get_cmap(cmap)(np.linspace(0, 1, max(len(components), 2)))
    color_of = dict(zip(components, colors))

    if ax is None:
        _, ax = plt.subplots(figsize=(7, 0.55 * len(names) + 1.0))
    positions = np.arange(len(names))[::-1]
    for pos, name in zip(positions, names):
        left = 0.0
        row = weights.loc[name]
        for component in components:
            value = float(row[component])
            if value <= 0:
                continue
            ax.barh(pos, value, left=left, color=color_of[component],
                    edgecolor="white", linewidth=0.5, height=0.7)
            if value >= min_label:
                ax.text(left + value / 2, pos, component, ha="center",
                        va="center", fontsize=7)
            left += value
        ax.text(1.01, pos, f"cos={float(decomp.cosine[name]):.3f}",
                va="center", fontsize=7)
    ax.set_yticks(positions)
    ax.set_yticklabels(names, fontsize=9)
    ax.set_xlim(0, 1.12)
    ax.set_xlabel("catalog mixture weight")
    ax.set_title("catalog decomposition", fontsize=10)
    return ax
