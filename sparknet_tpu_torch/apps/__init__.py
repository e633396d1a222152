"""Applications of the port: the CIFAR-10 app over the parallel
solvers (the ImageNet app comes with the port's LMDB readers)."""

from .cifar_app import CifarApp

__all__ = ["CifarApp"]
