"""Hyperparameter tuning walkthrough: TuneHyperparameters with k-fold CV.

Counterpart of ``examples/hyperparam_tuning.py``: a space of discrete
and range params, random search over a ``TrainClassifier`` of the port's
GBDT with 3-fold cross-validation, trials on threads (on one card they
share it), then the best model on held-out rows. The data is
scikit-learn's breast-cancer table, read from the copy this package
bundles.
"""

from __future__ import annotations

import numpy as np

from mmlspark_tpu_torch.examples._common import (
    load_breast_cancer, run_main, timed)


def make_split(seed: int = 0, n_train: int = 450):
    X, y = load_breast_cancer(return_X_y=True)
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(X))
    X, y = X[order], y[order]
    return X[:n_train], y[:n_train], X[n_train:], y[n_train:]


def run(device=None, seed: int = 0, n_train: int = 450, num_folds: int = 3,
        num_runs: int = 5, parallelism: int = 4, tune_seed: int = 7,
        min_auc: float = 0.95) -> dict:
    from mmlspark_tpu_torch.core.dataframe import DataFrame
    from mmlspark_tpu_torch.gbdt import GBDTClassifier
    from mmlspark_tpu_torch.automl.train import TrainClassifier
    from mmlspark_tpu_torch.automl.tune import (
        DiscreteHyperParam, HyperparamBuilder, RangeHyperParam,
        TuneHyperparameters)
    from mmlspark_tpu_torch.automl.metrics import ComputeModelStatistics

    Xtr, ytr, Xte, yte = make_split(seed, n_train)
    train = DataFrame({"features": Xtr, "label": ytr})
    test = DataFrame({"features": Xte, "label": yte})
    space = (HyperparamBuilder()
             .add_hyperparam("num_leaves", DiscreteHyperParam([7, 15, 31]))
             .add_hyperparam("num_iterations", DiscreteHyperParam([15, 30]))
             .add_hyperparam("learning_rate",
                             RangeHyperParam(0.03, 0.3, log=True))
             .build())
    with timed() as t:
        tuned = TuneHyperparameters(
            models=[TrainClassifier(
                model=GBDTClassifier(min_data_in_leaf=5, device=device),
                label_col="label")],
            param_space=space, evaluation_metric="AUC",
            num_folds=num_folds, num_runs=num_runs,
            parallelism=parallelism, seed=tune_seed).fit(train)

    hist = tuned.get_history()
    scored = tuned.transform(test)
    stats = ComputeModelStatistics(label_col="label").evaluate(scored)
    auc = float(stats["AUC"][0])
    acc = float(stats["accuracy"][0])
    assert auc > min_auc, auc
    return {"name": "hyperparam_tuning", "tune_s": t.seconds,
            "n_configs": hist.num_rows, "best_cv_auc": tuned.best_metric,
            "best_params": tuned.best_params, "auc": auc, "accuracy": acc,
            "_model": tuned,
            "lines": [f"searched {hist.num_rows} configs x {num_folds}-fold "
                      f"CV in {t.seconds:.1f}s; best CV AUC="
                      f"{tuned.best_metric:.4f} with {tuned.best_params}",
                      f"held-out: AUC={auc:.4f}, accuracy={acc:.4f}"]}


def main(argv=None) -> dict:
    return run_main(__doc__, run, argv)


if __name__ == "__main__":
    main()
