"""Synthetic federated dataset generator (the port's copy of
``fedtorch_tpu/data/synthetic.py``, numpy only: every draw comes in the
same place of the ``RandomState`` sequence, so the data is bitwise the
JAX package's).

Rebuild of the reference's LEAF-style synthetic task generator
(``loader/federated_datasets.py:143-304``): per-client tasks from a
gaussian linear model parameterized by heterogeneity knobs (alpha, beta):

* ``B_k ~ N(0, beta)``; feature means ``loc ~ N(B_k, 1)``; features drawn
  from ``N(loc, Sigma)`` with ``Sigma_ii = (i+1)^-1.2`` (:256-263);
* per-client weights ``w ~ N(u_k, 1)`` with ``u_k ~ N(0, alpha)``; labels
  ``argmax softmax(xw + eps)`` (classification) or ``xw + eps`` squeezed
  (regression) (:265-275);
* client sample counts ``~ min(lognormal(3,2) + 500, 1000)`` (:247-250);
* the bias column trick (:258-260, x gets a leading 1 column that is
  dropped after y is computed) is preserved for numeric parity.

Generated in numpy on host with a fixed seed (reference default 931231),
returned as plain arrays for `stack_partitions`.
"""
from __future__ import annotations

from typing import List, NamedTuple

import numpy as np


class SyntheticData(NamedTuple):
    client_x: List[np.ndarray]   # per-client [n_k, dim] float32
    client_y: List[np.ndarray]   # per-client [n_k] int64 / float32
    test_x: np.ndarray
    test_y: np.ndarray


def generate_synthetic(num_tasks: int, alpha: float = 0.0, beta: float = 0.0,
                       num_dim: int = 60, num_classes: int = 2,
                       regression: bool = False, seed: int = 931231,
                       min_num_samples: int = 500,
                       max_num_samples: int = 1000,
                       test_ratio: float = 0.2) -> SyntheticData:
    rng = np.random.RandomState(seed)
    if regression:
        num_classes = 1

    sigma = np.diag((np.arange(1, num_dim + 1)) ** (-1.2))

    num_samples = rng.lognormal(3, 2, num_tasks).astype(int)
    num_samples = [min(s + min_num_samples, max_num_samples)
                   for s in num_samples]

    client_x, client_y = [], []
    test_xs, test_ys = [], []
    for n_k in num_samples:
        # features (federated_datasets.py:256-263)
        b = rng.normal(loc=0.0, scale=beta)
        loc = rng.normal(loc=b, scale=1.0, size=num_dim)
        x = np.ones((n_k, num_dim + 1))
        x[:, 1:] = rng.multivariate_normal(mean=loc, cov=sigma, size=n_k)
        # labels (:265-275)
        u = rng.normal(loc=0, scale=alpha)
        w = rng.normal(loc=u, scale=1, size=(num_dim + 1, num_classes))
        out = x @ w + rng.normal(loc=u, scale=0.1, size=(n_k, num_classes))
        if regression:
            y = np.squeeze(out).astype(np.float32)
        else:
            y = np.argmax(out, axis=1).astype(np.int64)
        x = x[:, 1:].astype(np.float32)  # drop bias column (:287-291)
        # train/test split (:295-304)
        perm = rng.permutation(n_k)
        n_train = int(n_k * (1 - test_ratio))
        client_x.append(x[perm[:n_train]])
        client_y.append(y[perm[:n_train]])
        test_xs.append(x[perm[n_train:]])
        test_ys.append(y[perm[n_train:]])

    return SyntheticData(client_x=client_x, client_y=client_y,
                         test_x=np.concatenate(test_xs),
                         test_y=np.concatenate(test_ys))
