"""Applications of the port: the CIFAR-10 and ImageNet apps over the
parallel solvers."""

from .cifar_app import CifarApp
from .imagenet_app import ImageNetApp

__all__ = ["CifarApp", "ImageNetApp"]
