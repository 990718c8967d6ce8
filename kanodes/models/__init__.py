from kanodes.models.kdense import KDense, KDense1, KANChain
from kanodes.models.mlp import MLP
from kanodes.models.bspline import BSplineKAN, BSplineKANChain
from kanodes.models.hybrid import DataNormalizer, HybridKANMLP

__all__ = ["KDense", "KDense1", "KANChain", "MLP", "BSplineKAN",
           "BSplineKANChain", "DataNormalizer", "HybridKANMLP"]
