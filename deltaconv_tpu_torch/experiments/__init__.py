"""The port's experiment CLIs (counterparts of the JAX package's
``experiments/*.py``): the same flags and defaults, plus ``--device``.
Run as modules from the root of a checkout::

    python -m deltaconv_tpu_torch.experiments.train_scanobjectnn \\
        --data_root experiments/data/ScanObjectNN
    python -m deltaconv_tpu_torch.experiments.train_modelnet
    python -m deltaconv_tpu_torch.experiments.train_shrec
    python -m deltaconv_tpu_torch.experiments.train_shapenet
    python -m deltaconv_tpu_torch.experiments.test_shapenet \\
        --checkpoint RUN_DIR/checkpoints
    python -m deltaconv_tpu_torch.experiments.train_shapeseg
    python -m deltaconv_tpu_torch.experiments.synthetic_convergence
    python -m deltaconv_tpu_torch.experiments.offline_rehearsal
    python -m deltaconv_tpu_torch.experiments.anisotropic_diffusion.run_study
"""
