"""Geometry of the port: kNN (batched, one cloud, or tiled for a large
cloud), tangent frames (given or estimated), parallel transport, the
grad/div operators (their batched form from the build kernels, dense or
in coefficients, and the single-cloud build functions), the vector-field
operators, and farthest-point sampling. Exports every name of the JAX
package's ``deltaconv_tpu.geometry``."""

from .connection import angle_in_plane, build_transport, rotate_around
from .dense import DenseGradDiv, densify
from .fps import euclidean_fps, geodesic_fps
from .frames import build_tangent_basis, estimate_basis
from .grad_div import (GradDiv, build_grad_div, build_grad_div_tables,
                       coords_projected, fit_vector_mapping,
                       gaussian_weights, mean_edge_length,
                       weighted_least_squares)
from .knn import knn, knn_tiled
from .linalg import chol_solve, eigh3x3
from .operators import I_J, J, curl, hodge_laplacian, laplacian, norm
from .utils import EPS, batch_dot, normalize, safe_norm

__all__ = ["DenseGradDiv", "EPS", "GradDiv", "I_J", "J", "angle_in_plane",
           "batch_dot", "build_grad_div", "build_grad_div_tables",
           "build_tangent_basis", "build_transport", "chol_solve",
           "coords_projected", "curl", "densify", "eigh3x3",
           "estimate_basis", "euclidean_fps", "fit_vector_mapping",
           "gaussian_weights", "geodesic_fps", "hodge_laplacian", "knn",
           "knn_tiled", "laplacian", "mean_edge_length", "norm",
           "normalize", "rotate_around", "safe_norm",
           "weighted_least_squares"]
