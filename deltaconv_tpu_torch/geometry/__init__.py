"""Geometry of the f32 serving path: kNN, tangent frames, operators."""

from .dense import DenseGradDiv, densify
from .frames import build_tangent_basis
from .grad_div import GradDiv
from .knn import knn
from .operators import I_J, J, norm
from .utils import EPS, batch_dot, normalize, safe_norm

__all__ = ["DenseGradDiv", "EPS", "GradDiv", "I_J", "J", "batch_dot",
           "build_tangent_basis", "densify", "knn", "norm", "normalize",
           "safe_norm"]
