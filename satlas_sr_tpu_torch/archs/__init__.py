"""Network architectures of the port: the SSR_RRDBNet generator, SRCNN and HighResNet."""

from .highresnet import HighResNet
from .rrdbnet import RRDB, RRDBNet, ResidualDenseBlock
from .srcnn import SRCNN

__all__ = ["HighResNet", "RRDB", "RRDBNet", "ResidualDenseBlock", "SRCNN"]
