"""Classification datasets: the port's own copy of
``pathway_tpu/stdlib/ml/datasets/classification/__init__.py`` (reference:
stdlib/ml/datasets/classification — MNIST via sklearn's fetch_openml,
split 6/7 train, 1/7 test). scikit-learn, pandas and the network are needed
only when a loader is called; the card's machine has neither package, so
the loaders run where they are installed. Nothing is left out."""

from __future__ import annotations


def load_mnist_sample(sample_size: int = 70000):
    """(X_train, y_train, X_test, y_test) tables of MNIST vectors/labels.
    Requires scikit-learn and network access to openml.org at call time."""
    import numpy as np
    import pandas as pd

    try:
        from sklearn.datasets import fetch_openml
    except ImportError as e:  # pragma: no cover - sklearn not baked in
        raise ImportError(
            "load_mnist_sample requires scikit-learn, which is not "
            "installed in this environment"
        ) from e

    from pathway_tpu_torch.debug import table_from_pandas

    X, y = fetch_openml(
        "mnist_784", version=1, return_X_y=True, as_frame=False
    )
    X = X / 255.0
    train_size = int(sample_size * 6 / 7)
    test_size = int(sample_size / 7)
    X_train, y_train = X[:60000][:train_size], y[:60000][:train_size]
    X_test, y_test = X[60000:70000][:test_size], y[60000:70000][:test_size]

    def vec_table(arr):
        return table_from_pandas(
            pd.DataFrame({"data": [np.array(v) for v in arr.tolist()]})
        )

    def label_table(arr):
        return table_from_pandas(pd.DataFrame({"label": arr.tolist()}))

    return (
        vec_table(X_train),
        label_table(y_train),
        vec_table(X_test),
        label_table(y_test),
    )


load_mnist_stream = load_mnist_sample

__all__ = ["load_mnist_sample", "load_mnist_stream"]
