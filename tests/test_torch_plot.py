"""Plotting of salamander_tpu_torch under the Agg backend, mirroring
tests/test_plot.py, and held against the JAX package's plots.

The data helpers (get_obs_order, _reorder_data, _get_colors_barplot) give
what the JAX package's give. The drawing tests run on one container state
in both packages: a model fitted by the JAX package, saved, and loaded
into the port (the archive format is shared), so both plot the same
arrays; the drawn bar heights, positions and colors and the scatter
offsets are equal. The model methods the port gained with plot.py
(plot_history, plot_signatures, plot_exposures, plot_correlation,
plot_embeddings, plot_relevance, the multimodal ones) and the analysis
helpers (reorder, correlation) are covered the same way."""

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402

import salamander_tpu as jax_sal  # noqa: E402
from salamander_tpu import io as jax_io  # noqa: E402
from salamander_tpu import plot as jax_plot  # noqa: E402
from salamander_tpu_torch import datasets, io, plot  # noqa: E402
from salamander_tpu_torch.consts import (  # noqa: E402
    CN_TYPES_48,
    DBS_TYPES_78,
    INDEL_TYPES_83,
    SBS_TYPES_96,
    SV_TYPES_32,
)

N_SAMPLES = 30


@pytest.fixture(autouse=True)
def _close_figures():
    yield
    plt.close("all")


@pytest.fixture
def data():
    counts = np.array([[1, 1], [2, 3], [3, 2], [4, 4]])
    return pd.DataFrame(counts, index=["a", "b", "c", "d"])


def positions(order):
    return {name: int(np.where(order == name)[0][0]) for name in "abcd"}


def bars(ax):
    """(x, y, width, height, facecolor) of every drawn bar."""
    return [(p.get_x(), p.get_y(), p.get_width(), p.get_height(),
             p.get_facecolor()) for p in ax.patches]


def offsets(ax):
    return [np.asarray(c.get_offsets()) for c in ax.collections]


def assert_same_bars(ax, jax_ax):
    assert bars(ax) == bars(jax_ax)


def test_get_obs_order_normalized(data):
    order = plot.get_obs_order(data, normalize=True)
    pos = positions(order)
    # relative values: a == d (uniform rows), b and c are mirrored extremes
    assert abs(pos["a"] - pos["d"]) == 1
    assert abs(pos["b"] - pos["c"]) == 3
    np.testing.assert_array_equal(
        order, jax_plot.get_obs_order(data, normalize=True))


def test_get_obs_order_unnormalized(data):
    order = plot.get_obs_order(data, normalize=False)
    pos = positions(order)
    # absolute values: a and d are the extremes, b and c adjacent
    assert abs(pos["a"] - pos["d"]) == 3
    assert abs(pos["b"] - pos["c"]) == 1
    np.testing.assert_array_equal(
        order, jax_plot.get_obs_order(data, normalize=False))


def test_reorder_data_uses_relative_values(data):
    reordered = plot._reorder_data(data)
    pos = positions(reordered.index.to_numpy())
    assert abs(pos["a"] - pos["d"]) == 1
    assert abs(pos["b"] - pos["c"]) == 3
    pd.testing.assert_frame_equal(reordered, jax_plot._reorder_data(data))


def test_reorder_data_custom_order(data):
    custom = ["b", "a", "c", "d"]
    reordered = plot._reorder_data(data, obs_order=custom)
    assert list(reordered.index) == custom
    pd.testing.assert_frame_equal(
        reordered, jax_plot._reorder_data(data, obs_order=custom))


@pytest.mark.parametrize("var_names, colors", [
    (SBS_TYPES_96, None), (["x"] * 96, "SBS96"), (INDEL_TYPES_83, None),
    (DBS_TYPES_78, None), (["x"] * 78, "DBS78"), (CN_TYPES_48, None),
    (["x"] * 48, "CN48"), (SV_TYPES_32, None), (["x"] * 32, "SV32"),
    (["a", "b"], "red"), (["a", "b"], ("red",)), (["a", "b"], None),
    (["a", "b"], ["red", "blue"]),
])
def test_barplot_colors_equal_jax(var_names, colors):
    assert plot._get_colors_barplot(var_names, colors) == \
        jax_plot._get_colors_barplot(var_names, colors)


def test_barplot_colors_resolution():
    assert plot._get_colors_barplot(SBS_TYPES_96) == plot._get_colors_barplot(
        ["x"] * 96, "SBS96"
    )
    assert len(plot._get_colors_barplot(INDEL_TYPES_83)) == 83
    assert plot._get_colors_barplot(DBS_TYPES_78) == plot._get_colors_barplot(
        ["x"] * 78, "DBS78"
    )
    # 10 reference-doublet groups, contiguous group coloring
    assert len(set(plot._get_colors_barplot(DBS_TYPES_78))) == 10
    assert plot._get_colors_barplot(["a", "b"], "red") == ["red", "red"]
    assert plot._get_colors_barplot(["a", "b"]) == ["gray", "gray"]
    with pytest.raises(ValueError):
        plot._get_colors_barplot(["a", "b"], ["red"])
    with pytest.raises(ValueError):
        plot._get_colors_barplot(["a"] * 5, "SBS96")
    with pytest.raises(ValueError):
        plot._get_colors_barplot(["a"] * 5, "DBS78")


def test_barplot_colors_cn48_sv32():
    assert plot._get_colors_barplot(CN_TYPES_48) == plot._get_colors_barplot(
        ["x"] * 48, "CN48"
    )
    # 10 (total copy number, zygosity) groups, contiguous group coloring
    assert len(set(plot._get_colors_barplot(CN_TYPES_48))) == 10
    assert plot._get_colors_barplot(SV_TYPES_32) == plot._get_colors_barplot(
        ["x"] * 32, "SV32"
    )
    # 8 (cluster status, SV class) groups
    assert len(set(plot._get_colors_barplot(SV_TYPES_32))) == 8
    with pytest.raises(ValueError):
        plot._get_colors_barplot(["a"] * 5, "CN48")
    with pytest.raises(ValueError):
        plot._get_colors_barplot(["a"] * 5, "SV32")


def test_barplot_draws_resolved_channel_colors():
    """A one-signature SBS-96 barplot draws 96 bars whose facecolors are
    the auto-resolved trinucleotide palette and whose heights are the
    row-normalized values, as the JAX package's."""
    from matplotlib.colors import to_rgba

    rng = np.random.default_rng(0)
    values = rng.uniform(0.5, 2.0, size=96)
    frame = pd.DataFrame([values], index=["SigX"], columns=SBS_TYPES_96)
    ax = plot._barplot_single(frame)
    drawn = ax.patches
    assert len(drawn) == 96
    expected_colors = [to_rgba(c)
                       for c in plot._get_colors_barplot(SBS_TYPES_96)]
    assert [bar.get_facecolor() for bar in drawn] == expected_colors
    heights = np.array([bar.get_height() for bar in drawn])
    np.testing.assert_allclose(heights, values / values.sum(), rtol=1e-12)
    assert ax.get_title() == "SigX"
    assert_same_bars(ax, jax_plot._barplot_single(frame))


def test_stacked_barplot_layout():
    """Stacked exposure bars are row-normalized (per-sample stacks reach
    exactly 1), signatures stack in total-contribution order (largest at
    the bottom), and every bar is the JAX package's."""
    rng = np.random.default_rng(1)
    exposures = pd.DataFrame(
        rng.gamma(2.0, 10.0, size=(6, 3)),
        index=[f"s{i}" for i in range(6)],
        columns=["SigA", "SigB", "SigC"],
    )
    # make SigC dominate, SigA smallest
    exposures["SigC"] *= 10.0
    exposures["SigA"] *= 0.1
    ax = plot.stacked_barplot(exposures, annotate_obs=False)
    drawn = ax.patches
    n_samples, n_sigs = exposures.shape
    assert len(drawn) == n_samples * n_sigs
    tops = {}
    for bar in drawn:
        x = round(bar.get_x(), 6)
        tops[x] = max(tops.get(x, 0.0), bar.get_y() + bar.get_height())
    np.testing.assert_allclose(sorted(tops.values()), np.ones(n_samples),
                               rtol=1e-9)
    labels = [t.get_text() for t in ax.get_legend().get_texts()]
    assert labels == ["SigC", "SigB", "SigA"]
    assert_same_bars(ax, jax_plot.stacked_barplot(exposures,
                                                  annotate_obs=False))


def test_history_plot_x_grid():
    """history() plots the objective against the conv_test_freq grid."""
    values = [5.0, 4.0, 3.5, 3.3]
    ax = plot.history(values=values, conv_test_freq=10)
    line = ax.get_lines()[0]
    np.testing.assert_array_equal(line.get_xdata(), [10, 20, 30, 40])
    np.testing.assert_array_equal(line.get_ydata(), values)


def test_cn48_sv32_vocabulary_structure():
    # homdel carries 3 coarse length bins; every other CN group carries 5
    assert len(CN_TYPES_48) == len(set(CN_TYPES_48)) == 48
    homdel = [c for c in CN_TYPES_48 if c.split(":")[1] == "homdel"]
    assert len(homdel) == 3 and homdel[0] == "0:homdel:0-100kb"
    assert sum(c.split(":")[1] == "LOH" for c in CN_TYPES_48) == 25
    assert sum(c.split(":")[1] == "het" for c in CN_TYPES_48) == 20
    # translocations carry no length bin; the other SV classes carry 5
    assert len(SV_TYPES_32) == len(set(SV_TYPES_32)) == 32
    assert "clustered_trans" in SV_TYPES_32
    assert "non-clustered_trans" in SV_TYPES_32
    assert sum(c.endswith("_trans") for c in SV_TYPES_32) == 2
    assert SV_TYPES_32[0] == "clustered_del_1-10Kb"
    assert sum(c.startswith("clustered_") for c in SV_TYPES_32) == 16


def _shared(jax_model, tmp_path_factory, name):
    """The JAX model and the port model loaded from its checkpoint: one
    container state in both packages."""
    path = str(tmp_path_factory.mktemp(name) / "model.npz")
    jax_io.save_model(jax_model, path)
    return io.load_model(path, device="cpu"), jax_io.load_model(path)


@pytest.fixture(scope="module")
def fitted_pair(tmp_path_factory):
    counts = datasets.load_pcawg_sbs().iloc[:N_SAMPLES]
    jax_model = jax_sal.models.KLNMF(n_signatures=3, min_iterations=30,
                                     max_iterations=30)
    jax_model.fit(jax_sal.AnnData(counts))
    return _shared(jax_model, tmp_path_factory, "klnmf")


@pytest.fixture
def fitted_model(fitted_pair):
    return fitted_pair[0]


def test_history_plot(fitted_pair):
    model, jax_model = fitted_pair
    ax = model.plot_history()
    assert ax.get_xlabel() == "n_iteration"
    lines = ax.get_lines()
    assert len(lines) == 1
    assert len(lines[0].get_xdata()) == len(
        model.history["objective_function"]
    )
    jax_line = jax_model.plot_history().get_lines()[0]
    np.testing.assert_array_equal(lines[0].get_xydata(),
                                  jax_line.get_xydata())


def test_history_min_iteration_guard(fitted_model):
    with pytest.raises(ValueError):
        fitted_model.plot_history(min_iteration=10_000_000)


def test_signature_barplots(fitted_pair):
    model, jax_model = fitted_pair
    axes = model.plot_signatures()
    assert len(axes) == 3
    assert axes[0].get_title() == "Sig1"
    for ax, jax_ax in zip(axes, jax_model.plot_signatures()):
        assert ax.get_title() == jax_ax.get_title()
        assert_same_bars(ax, jax_ax)


def test_stacked_exposures(fitted_pair):
    model, jax_model = fitted_pair
    ax = model.plot_exposures()
    assert len(ax.patches) == 3 * N_SAMPLES
    assert_same_bars(ax, jax_model.plot_exposures())
    assert [t.get_text() for t in ax.get_xticklabels()] == \
        [t.get_text() for t in jax_model.plot_exposures().get_xticklabels()]


def test_correlation_plot(fitted_pair):
    model, jax_model = fitted_pair
    grid = model.plot_correlation()
    assert grid is not None
    jax_grid = jax_model.plot_correlation()
    np.testing.assert_array_equal(grid.data2d.to_numpy(),
                                  jax_grid.data2d.to_numpy())
    pd.testing.assert_frame_equal(model.correlation("samples"),
                                  jax_model.correlation("samples"))


def test_embedding_plot(fitted_pair):
    # 3 signatures -> reduce_dimension over exposures, pca path
    model, jax_model = fitted_pair
    ax = model.plot_embeddings(method="pca")
    assert ax.get_xlabel() == "PC1"
    jax_ax = jax_model.plot_embeddings(method="pca")
    for got, expected in zip(offsets(ax), offsets(jax_ax), strict=True):
        np.testing.assert_allclose(got, expected, rtol=1e-12, atol=1e-12)


def test_embedding_plot_low_rank_warns(tmp_path_factory):
    counts = datasets.load_pcawg_sbs().iloc[:N_SAMPLES]
    jax_model = jax_sal.models.KLNMF(n_signatures=2, min_iterations=5,
                                     max_iterations=5)
    jax_model.fit(jax_sal.AnnData(counts))
    model, jax_model = _shared(jax_model, tmp_path_factory, "low_rank")
    with pytest.warns(UserWarning):
        ax = model.plot_embeddings(method="pca")
    with pytest.warns(UserWarning):
        jax_ax = jax_model.plot_embeddings(method="pca")
    for got, expected in zip(offsets(ax), offsets(jax_ax), strict=True):
        np.testing.assert_array_equal(got, expected)


def test_scatter_numpy_1d_and_2d():
    ax = plot.scatter_numpy(np.arange(5.0),
                            annotations=[str(i) for i in range(5)])
    jax_ax = jax_plot.scatter_numpy(np.arange(5.0),
                                    annotations=[str(i) for i in range(5)])
    for got, expected in zip(offsets(ax), offsets(jax_ax), strict=True):
        np.testing.assert_array_equal(got, expected)
    assert [t.get_text() for t in ax.texts] == \
        [t.get_text() for t in jax_ax.texts]
    points = np.random.default_rng(0).normal(size=(6, 2))
    for got, expected in zip(offsets(plot.scatter_numpy(points)),
                             offsets(jax_plot.scatter_numpy(points)),
                             strict=True):
        np.testing.assert_array_equal(got, expected)
    with pytest.raises(ValueError):
        plot.scatter_numpy(np.zeros((4, 3)))


def test_barplot_with_catalog_matching(fitted_model):
    catalog = pd.DataFrame(
        np.random.default_rng(0).dirichlet(
            np.ones(fitted_model.adata.n_vars), size=7
        ),
        index=[f"CAT{i}" for i in range(7)],
        columns=fitted_model.adata.var_names,
    )
    axes = plot.barplot_pandas(fitted_model.signatures, catalog=catalog)
    assert axes.shape == (3, 2)  # each signature next to its best match
    jax_axes = jax_plot.barplot_pandas(fitted_model.signatures,
                                       catalog=catalog)
    for ax, jax_ax in zip(axes.flat, jax_axes.flat):
        assert ax.get_title() == jax_ax.get_title()
        assert_same_bars(ax, jax_ax)


def test_exposure_uncertainty_plot():
    from salamander_tpu.assign import (
        BootstrapExposuresResult as JaxBootstrapExposuresResult,
    )
    from salamander_tpu_torch.assign import BootstrapExposuresResult

    rng = np.random.default_rng(0)
    samples = [f"s{d}" for d in range(3)]
    sigs = [f"Sig{k}" for k in range(5)]
    point = pd.DataFrame(rng.gamma(2.0, 100.0, (3, 5)), index=samples,
                         columns=sigs)
    spread = 0.15 * point
    fields = dict(
        point=point,
        mean=point,
        std=spread,
        quantiles={0.05: point - spread, 0.95: point + spread},
        presence=pd.DataFrame(rng.random((3, 5)), index=samples,
                              columns=sigs),
    )
    ax = plot.exposure_uncertainty(BootstrapExposuresResult(**fields), "s1",
                                   top=4)
    assert len(ax.get_yticklabels()) == 4
    labels = {t.get_text() for t in ax.get_yticklabels()}
    assert labels <= set(sigs)
    jax_ax = jax_plot.exposure_uncertainty(
        JaxBootstrapExposuresResult(**fields), "s1", top=4)
    assert_same_bars(ax, jax_ax)


def test_decomposition_plot():
    from salamander_tpu_torch import tools as tl

    C = np.full((6, 18), 0.01)
    for k in range(6):
        C[k, k * 3:(k + 1) * 3] += 1.0
    C = C / C.sum(axis=1, keepdims=True)
    catalog = pd.DataFrame(
        C, index=[f"SBS{k+1}" for k in range(6)],
        columns=[f"f{v}" for v in range(18)],
    )
    sigs = pd.DataFrame(
        [0.6 * C[0] + 0.4 * C[2], C[4]],
        index=["Sig1", "Sig2"], columns=catalog.columns,
    )
    decomp = tl.decompose_signatures(sigs, catalog, device="cpu")
    ax = plot.decomposition(decomp)
    assert [t.get_text() for t in ax.get_yticklabels()] == ["Sig1", "Sig2"]
    # stacked segments cover the unit interval per signature
    widths = [p.get_width() for p in ax.patches]
    np.testing.assert_allclose(sum(widths), 2.0, rtol=1e-6)
    assert_same_bars(ax, jax_plot.decomposition(decomp))


# ---------------------------------------------------------------------- #
# the other families' plots and the analysis helpers
# ---------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def corrnmf_pair(tmp_path_factory):
    counts = datasets.load_pcawg_sbs().iloc[:N_SAMPLES]
    np.random.seed(0)
    jax_model = jax_sal.models.CorrNMFDet(n_signatures=3, dim_embeddings=3,
                                          min_iterations=10,
                                          max_iterations=10)
    jax_model.fit(jax_sal.AnnData(counts))
    return _shared(jax_model, tmp_path_factory, "corrnmf")


def test_corrnmf_embedding_plot(corrnmf_pair):
    """The joint signature/sample embedding, reduced by PCA: the same
    points, colors, draw order and annotations as the JAX package's."""
    model, jax_model = corrnmf_pair
    ax = model.plot_embeddings(method="pca")
    jax_ax = jax_model.plot_embeddings(method="pca")
    for got, expected in zip(offsets(ax), offsets(jax_ax), strict=True):
        np.testing.assert_allclose(got, expected, rtol=1e-12, atol=1e-12)
    assert [t.get_text() for t in ax.texts] == model.signature_names
    assert list(model.adata.obs["color_embeddings"]) == \
        list(jax_model.adata.obs["color_embeddings"])


def test_ardnmf_relevance_plot(tmp_path_factory):
    counts = datasets.load_pcawg_sbs().iloc[:N_SAMPLES]
    jax_model = jax_sal.models.ARDNMF(n_signatures=5, min_iterations=50,
                                      max_iterations=50)
    jax_model.fit(jax_sal.AnnData(counts))
    model, jax_model = _shared(jax_model, tmp_path_factory, "ardnmf")
    ax = model.plot_relevance()
    assert ax.get_yscale() == "log"
    assert_same_bars(ax, jax_model.plot_relevance())
    assert [t.get_text() for t in ax.get_xticklabels()] == \
        list(model.relevance.sort_values(ascending=False).index)


@pytest.fixture(scope="module")
def multimodal_pair(tmp_path_factory):
    mdata = jax_sal.MuData({
        "sbs": jax_sal.AnnData(datasets.load_pcawg_sbs().iloc[:N_SAMPLES]),
        "sv": jax_sal.AnnData(datasets.load_pcawg_sv().iloc[:N_SAMPLES]),
    })
    np.random.seed(0)
    jax_model = jax_sal.models.MultimodalCorrNMF(
        ns_signatures=[3, 2], dim_embeddings=3, min_iterations=20,
        max_iterations=20)
    jax_model.fit(mdata)
    return _shared(jax_model, tmp_path_factory, "multimodal")


def test_multimodal_plots(multimodal_pair):
    model, jax_model = multimodal_pair
    line = model.plot_history().get_lines()[0]
    np.testing.assert_array_equal(
        line.get_xydata(), jax_model.plot_history().get_lines()[0]
        .get_xydata())
    axes, jax_axes = model.plot_signatures(), jax_model.plot_signatures()
    assert axes.shape == jax_axes.shape == (3, 2)
    for ax, jax_ax in zip(axes.flat, jax_axes.flat):
        if ax.figure is not None and ax in ax.figure.axes:
            assert_same_bars(ax, jax_ax)
    for ax, jax_ax in zip(model.plot_exposures(),
                          jax_model.plot_exposures(), strict=True):
        assert ax.get_title() == jax_ax.get_title()
        assert_same_bars(ax, jax_ax)
    grid, jax_grid = model.plot_correlation(), jax_model.plot_correlation()
    np.testing.assert_array_equal(grid.data2d.to_numpy(),
                                  jax_grid.data2d.to_numpy())
    ax = model.plot_embeddings(method="pca")
    jax_ax = jax_model.plot_embeddings(method="pca")
    for got, expected in zip(offsets(ax), offsets(jax_ax), strict=True):
        np.testing.assert_allclose(got, expected, rtol=1e-12, atol=1e-12)


def test_reorder_and_correlation_equal_jax(fitted_pair):
    """reorder (Hungarian on cosine distance) and the sample and
    signature correlations give the JAX package's on the same state."""
    model, jax_model = fitted_pair
    target = model.asignatures[[2, 0, 1], :].copy()
    model.reorder(target)
    jax_model.reorder(target)
    np.testing.assert_array_equal(model.asignatures.X,
                                  jax_model.asignatures.X)
    np.testing.assert_array_equal(model.adata.obsm["exposures"],
                                  jax_model.adata.obsm["exposures"])
    assert model.signature_names == jax_model.signature_names
    for data in ("signatures", "samples"):
        pd.testing.assert_frame_equal(model.correlation(data),
                                      jax_model.correlation(data))
