"""Network architectures of the port: the SSR_RRDBNet generator, SRCNN and HighResNet,
and the U-Net SN discriminator."""

from .discriminator import UNetDiscriminatorSN
from .highresnet import HighResNet
from .rrdbnet import RRDB, RRDBNet, ResidualDenseBlock
from .srcnn import SRCNN

__all__ = ["HighResNet", "RRDB", "RRDBNet", "ResidualDenseBlock", "SRCNN", "UNetDiscriminatorSN"]
