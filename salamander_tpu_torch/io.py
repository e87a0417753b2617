"""Model persistence, held against salamander_tpu/io.py. Ported so far: the
constructor hyperparameters of each model class (``_HYPERPARAM_KEYS``,
copied), which bootstrap_stability and MultimodalCorrNMF.transform use to
clone a fitted model (they pass ``device=`` beside these keys: the device
is where a model runs, not what it is, so it stays out of the table);
saving and loading models wait for the I/O slice."""

from __future__ import annotations

_HYPERPARAM_KEYS = {
    "KLNMF": ["n_signatures", "init_method", "min_iterations", "max_iterations",
              "conv_test_freq", "tol", "dtype"],
    "ARDNMF": ["n_signatures", "prior", "a", "b", "init_method",
               "min_iterations", "max_iterations", "conv_test_freq", "tol",
               "dtype"],
    "MvNMF": ["n_signatures", "init_method", "lam", "delta", "min_iterations",
              "max_iterations", "conv_test_freq", "tol", "dtype"],
    "CorrNMFDet": ["n_signatures", "init_method", "dim_embeddings",
                   "min_iterations", "max_iterations", "conv_test_freq", "tol",
                   "dtype", "newton_cg_compat"],
    "MultimodalCorrNMF": ["ns_signatures", "dim_embeddings", "init_method",
                          "min_iterations", "max_iterations", "conv_test_freq",
                          "tol", "dtype", "newton_cg_compat"],
}
