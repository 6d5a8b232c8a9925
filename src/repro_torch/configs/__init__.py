from .base import ArchConfig, ShapeConfig, SHAPES, shape_applicable  # noqa: F401
from .registry import ARCHS, get_arch, smoke_config  # noqa: F401
