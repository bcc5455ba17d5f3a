"""Offline closure training (PyTorch).

Counterpart of finitedifference_tpu/training. Ported so far: the
projected training pairs (rnm_train.project_snapshots); the RBF fits
(rbf_train: dedup, the global (epsilon x kernel) grid search, its
cross-validated, Bayesian and anisotropic variants, the kNN (k, epsilon,
ridge) search, SVR (on svr.py's batched libsvm solver), the .npz model
file); the GP fits (gp_train: train_gp, save_gp, load_gp); the RNM
network's trainer (rnm_train.train_rnm: Adam in optax's form, a plateau
schedule, early stop) and its TrainingMonitor (monitor: best-checkpoint
torch state dicts with JAX's JSON sidecar). Not yet: training/data and
the autoencoder trainer.
"""
