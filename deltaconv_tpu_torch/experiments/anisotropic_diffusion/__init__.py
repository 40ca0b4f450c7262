"""The anisotropic-diffusion study in PyTorch (the port's counterpart of
``experiments/anisotropic_diffusion/``): six image ResNets, each block an
image version of a point-cloud operator family, trained to mimic
Perona-Malik anisotropic diffusion (the paper's Figure 2).

- :mod:`.diffusion`: the normalized Sobel gradient, the 3x3 Laplacian and
  the Perona-Malik target;
- :mod:`.architectures`: the six networks and
  :func:`~.architectures.state_dict_from_flax_study`, which carries each
  network's flax parameters into its ``state_dict``;
- :mod:`.run_study`: the study's command line (``python -m
  deltaconv_tpu_torch.experiments.anisotropic_diffusion.run_study``).
"""
