"""Offline closure training (PyTorch).

Counterpart of finitedifference_tpu/training. Ported so far: the
projected training pairs (rnm_train.project_snapshots) and the RBF fits
(rbf_train: dedup, the global (epsilon x kernel) grid search, the kNN
(k, epsilon, ridge) search, the .npz model file). The RBF closures need
no network: their fits are deterministic linear algebra.
"""
