"""Geometry of the serving path: kNN, tangent frames (given or
estimated), operators, and farthest-point sampling."""

from .dense import DenseGradDiv, densify
from .fps import euclidean_fps, geodesic_fps
from .frames import build_tangent_basis, estimate_basis
from .grad_div import GradDiv
from .knn import knn
from .linalg import chol_solve, eigh3x3
from .operators import I_J, J, norm
from .utils import EPS, batch_dot, normalize, safe_norm

__all__ = ["DenseGradDiv", "EPS", "GradDiv", "I_J", "J", "batch_dot",
           "build_tangent_basis", "chol_solve", "densify", "eigh3x3",
           "estimate_basis", "euclidean_fps", "geodesic_fps", "knn", "norm",
           "normalize", "safe_norm"]
